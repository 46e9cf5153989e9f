"""The yardstick the int8 kernels are held to on the path's own activations:
a context manager that routes each kernel's wrapper (and the preprocess) to
its plain PyTorch version, on whatever device the tensors are, and the
forward whose logits are compared with and without it; and one that runs the
int8 blocks in the XLA form, a scheme the gate reads (``int8_gate.py``).
Nothing serves through any of them.
"""

from __future__ import annotations

from contextlib import ExitStack, contextmanager
from unittest import mock

import numpy as np

# the wrappers that plain_int8_ops routes, by the name each module gives them
WRAPPERS = ("preprocess_u8", "fused_rowquant", "fused_qkv_attention_quant",
            "fused_qkv_attention_quant_flat", "fused_vit_block",
            "int8_matmul_scale_bias", "int8_matmul_gelu_quant",
            "int8_matmul_res_ln_quant", "int8_matmul_res")


def plain_versions() -> list[tuple]:
    """(module, wrapper name, plain version) of each name in ``WRAPPERS``."""
    from chess_vision_tpu_torch.ops import attention as attn_ops
    from chess_vision_tpu_torch.ops import fused_block as fb
    from chess_vision_tpu_torch.ops import int8_matmul as mm
    from chess_vision_tpu_torch.ops import preprocess as pre_ops
    from chess_vision_tpu_torch.ops import rowquant as rq

    out = [(pre_ops, "preprocess_u8", pre_ops.preprocess_u8_plain),
           (rq, "fused_rowquant", rq.rowquant_plain),
           (attn_ops, "fused_qkv_attention_quant",
            attn_ops.reference_attention_quant),
           (attn_ops, "fused_qkv_attention_quant_flat",
            attn_ops.reference_attention_quant_flat),
           (fb, "fused_vit_block", fb.fused_vit_block_plain)]
    out += [(mm, f"int8_matmul_{k}", getattr(mm, f"int8_matmul_{k}_plain"))
            for k in mm.LAUNCHES]
    return out


@contextmanager
def plain_int8_ops(keep: tuple[str, ...] = ()):
    """Route the int8 forward's kernels and the preprocess through their
    plain PyTorch versions, all but the wrappers named in ``keep`` (names of
    ``WRAPPERS``), which go on launching their kernels."""
    unknown = set(keep) - set(WRAPPERS)
    if unknown:
        raise ValueError(f"no int8 wrapper named {sorted(unknown)}")
    with ExitStack() as stack:
        for module, name, plain in plain_versions():
            if name not in keep:
                stack.enter_context(mock.patch.object(module, name, plain))
        yield


@contextmanager
def xla_form_blocks():
    """Run the int8 forward's blocks in the XLA form (``quant._block``: the
    arithmetic of the ``xla`` layout), in place of the block layout's: bf16
    attention through
    ``fused_qkv_attention`` (K2 on a CUDA tensor), then dynamic per-row
    quantization of each product's input. A measurement of that scheme on
    the same weights (``int8_gate.py``), not a serving layout; a
    Predictor's calibrated shifts go unused, K2 takes each row's maximum."""
    from chess_vision_tpu_torch.ops import quant

    def block(x, xq, xs, q, next_ln, num_heads=12, softmax_shift=None,
              gelu="sigmoid", modes=None):
        return quant._block(x, q, num_heads, gelu), None, None

    with mock.patch.object(quant, "block_int8", block):
        yield


def forward_logits(predictor, boards, batch: int = 256) -> dict[str, np.ndarray]:
    """The heads' logits of ``predictor``'s forward on ``boards``, in
    batches of ``batch``: its int8 pack under its layout where it has one,
    else its model. ``boards`` are uint8 (N, S, S, 3) RGB boards or, for a
    Predictor in ycbcr420 mode, a tuple of its (Y, Cb, Cr) plane stacks (RGB
    boards are then converted on the host, as ``predict_array`` does). Each
    head's array, concatenated over the batches, on the host."""
    import torch

    from chess_vision_tpu_torch.config import get_data_config
    from chess_vision_tpu_torch.ops import preprocess as pre_ops
    from chess_vision_tpu_torch.ops import quant
    from chess_vision_tpu_torch.serve import model_input

    model_cfg = predictor.cfg["model"]
    data_cfg = get_data_config(model_cfg.get("name", ""))
    mean, std = data_cfg["mean"], data_cfg["std"]
    if predictor.mode == "ycbcr420" and not isinstance(boards, tuple):
        boards = pre_ops.rgb_to_ycbcr420_batch(boards)
    arrays = boards if isinstance(boards, tuple) else (boards,)
    outs = []
    with torch.inference_mode():
        for start in range(0, len(arrays[0]), batch):
            inputs = [torch.from_numpy(a[start:start + batch]).to(predictor.device)
                      for a in arrays]
            if predictor.pack is not None:
                x = model_input(inputs, mean, std, torch.bfloat16,
                                predictor.mode)
                out = quant.chessvit_int8_apply(
                    predictor.pack, x, predictor.attn_shifts,
                    gelu=predictor.gelu,
                    num_heads=model_cfg.get("num_heads", 12),
                    layout=predictor.layout, modes=predictor.int8_modes)
            else:
                x = model_input(inputs, mean, std, predictor.model.dtype,
                                predictor.mode)
                out = predictor.model(x)
            outs.append({k: v.float().cpu().numpy() for k, v in out.items()})
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
