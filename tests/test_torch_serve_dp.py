"""Serving and evaluation over several devices: ``Predictor(devices=[...])``
(one replica of the model or of the int8 pack per device, each batch cut
into contiguous shards) and ``evaluate(..., devices=[...])`` against one
device, here on two "devices" that are both the CPU (the list may repeat a
device, as two replicas on one card); a data-parallel rank's loader; then
the port's counterpart of the JAX package's ``dryrun_multichip``
(``__graft_entry__.py``) on four gloo ranks. FENs and the evaluation report must be identical: the shards run the
same ops on the same rows (the evaluation's unrounded mean loss adds the
shards' sums: within 1e-6 of one device's)."""

import contextlib
import io

import numpy as np
import pytest
import torch

from chess_vision_tpu_torch.convert.jax_params import tree_from_state_dict
from chess_vision_tpu_torch.models import build_model, init_weights
from chess_vision_tpu_torch.ops import attention  # noqa: F401 (first exp)
from chess_vision_tpu_torch.parallel import dryrun
from chess_vision_tpu_torch.serve import Predictor

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights():
    cfg = dryrun.tiny_config(mixed=True)
    cfg["model"]["name"] = "vit_base_patch16_224.augreg_in21k"
    params = tree_from_state_dict(
        init_weights(build_model(cfg), seed=3).state_dict())
    images = np.random.default_rng(2).integers(0, 256, (10, 64, 64, 3),
                                               dtype=np.uint8)
    return cfg, params, images


@pytest.mark.parametrize("quant", [None, "int8"])
def test_two_devices_serve_the_fens_of_one(weights, quant):
    cfg, params, images = weights
    one = Predictor((cfg, params), batch_size=4, quant=quant, device="cpu")
    two = Predictor((cfg, params), batch_size=4, quant=quant,
                    devices=["cpu", "cpu"])
    assert len(two.infers) == 2
    if quant:  # one calibration, its shifts shared by the replicas
        assert two.packs[0] is not two.packs[1]
    ours = two.predict_array(images)
    assert len(ours) == len(images)  # a padded tail batch
    assert ours == one.predict_array(images)


def test_a_batch_that_does_not_divide_raises(weights):
    cfg, params, _ = weights
    with pytest.raises(ValueError, match="not divisible by 3 devices"):
        Predictor((cfg, params), batch_size=4, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="device or devices"):
        Predictor((cfg, params), batch_size=4, device="cpu", devices=["cpu"])


def test_evaluate_over_two_devices_equals_one(weights, tmp_path):
    from chess_vision_tpu_torch.data import BatchLoader
    from chess_vision_tpu_torch.evaluate import evaluate

    cfg, params, images = weights

    class Boards:
        use_manifest = False
        samples = [{"filename": f"{i}.png"} for i in range(len(images))]

        def __len__(self):
            return len(images)

        def labels_for(self, idx):
            rng = np.random.default_rng(idx)
            return {"squares": rng.integers(0, 13, 64).astype(np.int32),
                    "turn": np.array([idx % 2], np.float32),
                    "castling": rng.integers(0, 2, 4).astype(np.float32),
                    "legal": np.ones(1, np.float32)}

        def load_image(self, idx):
            return images[idx]

    model = build_model(cfg)
    model.load_state_dict(
        init_weights(build_model(cfg), seed=3).state_dict())
    model = model.cast_weights().eval()
    reports = []
    for devices in (None, ["cpu", "cpu"]):
        loader = BatchLoader(Boards(), np.arange(len(images)), 4, num_workers=0)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            metrics = evaluate(model, Boards(), loader, (0.5,) * 3, (0.5,) * 3,
                               devices=devices)
        reports.append((metrics, out.getvalue()))
    # the printed report is identical; the loss sum adds the shards' sums,
    # so the unrounded mean may differ in its last bits
    (one, text_one), (two, text_two) = reports
    assert text_two == text_one
    assert one.keys() == two.keys() and one["total_boards"] == len(images)
    for key in one:
        if key == "loss":
            assert two[key] == pytest.approx(one[key], rel=1e-6)
        else:
            assert two[key] == one[key], key


def test_loader_shards_cut_the_global_batch_and_decode_their_rows_alone():
    """A data-parallel rank's loader (``BatchLoader(shard=...)``) yields its
    contiguous slice of each global batch, padding included, and decodes
    only those rows."""
    from chess_vision_tpu_torch.data import BatchLoader
    from chess_vision_tpu_torch.parallel.mesh import shard_batch

    class Boards:
        def __init__(self):
            self.decoded = []

        def labels_for(self, i):
            return {"squares": np.full(64, i % 13), "turn": np.ones(1, np.float32),
                    "castling": np.zeros(4, np.float32),
                    "legal": np.ones(1, np.float32)}

        def load_image(self, i):
            self.decoded.append(int(i))
            return np.full((4, 4, 3), i, np.uint8)

    def batches(shard):
        boards = Boards()
        loader = BatchLoader(boards, np.arange(11), 4, shuffle=True, seed=5,
                             num_workers=1, shard=shard)
        return list(loader), boards.decoded

    full, decoded_full = batches((0, 1))
    assert len(full) == 3 and full[-1]["n_real"] == 3  # a padded tail
    for rank in range(2):
        ours, decoded = batches((rank, 2))
        assert len(decoded) == len(decoded_full) // 2
        for mine, whole in zip(ours, full):
            cut = shard_batch(whole, rank, 2)
            assert mine.keys() == whole.keys()
            for key in mine:
                if key != "n_real":
                    np.testing.assert_array_equal(mine[key], cut[key])
            assert mine["n_real"] == int(cut["mask"].sum())
    with pytest.raises(ValueError, match="not divisible by 3 devices"):
        BatchLoader(Boards(), np.arange(11), 4, shard=(0, 3))


def test_dryrun_multichip_three_surfaces():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(4)  # the card unless the CPU is asked for
    out = dryrun.dryrun_multichip(4, "cpu", dryrun.tiny_config(mixed=True))
    assert np.isfinite(out["fsdp"]) and np.isfinite(out["tp_fsdp"])
    assert out["tp"] == 4 and out["int8_boards"] == 8
