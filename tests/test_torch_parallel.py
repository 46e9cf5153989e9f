"""Training over several ranks (``chess_vision_tpu_torch/parallel/mesh.py``):
spawned gloo process groups on the CPU (world 2 and 4, each spawned once for
the file, each on a free port) run a few train steps of a tiny model on the
same weights, batches and draws as one device
(``parallel/dryrun.compare_ranks``); the oracle is the JAX package's own:
partitioning preserves semantics (``tests/test_parallel.py``,
``tests/test_tp.py``). Then one dp2 x tp2 step against the JAX package's
dp2 x tp2 step on the test configuration's 8-device CPU mesh, and the TP
layout: head-aligned cuts that gather back to the JAX layout bit for bit.

Tolerances (f32; head dropout 0.1 and drop path 0.1 on, except against
JAX; the backbone's dropouts 0.1 in one dp2 x tp2 run; a planted fault, no
gradient sum over the data axis, must fail them):
losses rtol 1e-5, the same arithmetic with sums in another order (a
gradient summed over ranks, a product cut over the model axis); parameters
after two steps within the worst case of AdamW's sign flips, 2 * lr * steps,
with 99% of the entries within a thousandth of it (read: DP 4e-6, TP 1.3e-5
at most, against 4e-3). The square model's BatchNorm under batch statistics
is noise-limited in f32 (``tests/test_torch_arch_train.py``), so it takes
one step: its running statistics are held to 1e-5 relative, its parameters
to the same AdamW bound."""

import jax
import numpy as np
import pytest
import torch

from chess_vision_tpu import augment as jaug
from chess_vision_tpu.models import build_model as jax_build_model
from chess_vision_tpu.models import init_variables
from chess_vision_tpu.parallel.mesh import (
    make_mesh_2d,
    replicated,
    shard_batch,
    tp_tree_sharding,
)
from chess_vision_tpu.train import loop as jloop
from chess_vision_tpu.train import state as jstate
from chess_vision_tpu_torch.convert.jax_params import state_dict_from_tree
from chess_vision_tpu_torch.models import build_model
from chess_vision_tpu_torch.ops import attention  # noqa: F401 (first exp)
from chess_vision_tpu_torch.parallel import dryrun, mesh

torch.set_num_threads(2)
LR, STEPS = 1e-3, 2
WEIGHTS = np.linspace(0.5, 1.5, 13).astype(np.float32)
VIT = dryrun.tiny_config()
SQUARE = dryrun.tiny_config("square", pin_backbone_bn=False)
BATCHES = dryrun.random_batches(STEPS, 8)
# one step: under batch statistics a ReLU input within rounding of 0 may flip
# once the parameters differ by AdamW's sign flips, and move its channel's
# statistics (tests/test_torch_arch_train.py), so the square model's later
# steps are noise-limited in f32
SQUARE_BATCHES = dryrun.random_batches(1, 4, seed=1)


def _jax_aug(aug_rng, batch):
    keys = jax.random.split(aug_rng, batch)
    kj = jax.vmap(lambda k: jax.random.split(k, 7)[0])(keys)
    fb, fc, fs, fh, which = jax.vmap(jaug._color_jitter_params)(kj)
    pg, pb, sigma, pc, cperm, pi = jax.vmap(jaug._rest_params)(keys)
    names = ("brightness", "contrast", "saturation", "hue", "order", "gray_u",
             "blur_u", "sigma", "perm_u", "channel_perm", "invert_u")
    values = (fb, fc, fs, fh, which, pg, pb, sigma, pc, cperm, pi)
    return {n: np.array(v) for n, v in zip(names, values)}


@pytest.fixture(scope="module")
def jax_dp2_tp2():
    """The JAX package's dp2 x tp2 train steps on its 8-device CPU mesh, and
    what the port needs to run the same steps: weights, draws, batches."""
    cfg = dryrun.tiny_config(head_dropout=0.0, drop_path_rate=0.0)
    jmodel = jax_build_model(cfg)
    variables = init_variables(jmodel, 64, seed=1)
    params = jax.tree.map(np.asarray, variables["params"])
    grid = make_mesh_2d(2, jax.devices()[:4])
    state, _ = jstate.create_train_state(cfg, variables, len(BATCHES))
    rep = replicated(grid)
    state = jax.device_put(state, state.replace(
        params=tp_tree_sharding(grid, state.params),
        opt_state=tp_tree_sharding(grid, state.opt_state),
        batch_stats=jax.tree.map(lambda _: rep, state.batch_stats), step=rep))
    train, _ = jloop.make_steps(jmodel, cfg, None, dryrun.MEAN, dryrun.STD)
    train = jax.jit(train)
    base_rng = jax.random.key(0)
    losses, aug = [], []
    for step, batch in enumerate(BATCHES):
        aug_rng, _ = jax.random.split(jax.random.fold_in(base_rng, step))
        aug.append(_jax_aug(aug_rng, len(batch["mask"])))
        state, sums = train(state, shard_batch(batch, grid), base_rng)
        losses.append(float(sums["step_loss"]))
    return {"cfg": cfg, "state_dict": state_dict_from_tree(params), "aug": aug,
            "losses": losses,
            "params": state_dict_from_tree(jax.tree.map(np.asarray,
                                                        state.params))}


@pytest.fixture(scope="module")
def one_rank():
    return {"vit": dryrun.train_steps(VIT, BATCHES, "cpu"),
            "weights": dryrun.train_steps(VIT, BATCHES, "cpu",
                                          class_weights=WEIGHTS),
            "dropout": dryrun.train_steps(VIT, BATCHES, "cpu", dropout=0.1),
            "square": dryrun.train_steps(SQUARE, SQUARE_BATCHES, "cpu")}


@pytest.fixture(scope="module")
def ranks2():
    return dryrun.compare_ranks(2, {
        "dp": dict(cfg=VIT, batches=BATCHES),
        "unsummed": dict(cfg=VIT, batches=BATCHES, plant="no_gradient_sum"),
        "weights": dict(cfg=VIT, batches=BATCHES, class_weights=WEIGHTS),
        "fsdp": dict(cfg=VIT, batches=BATCHES, fsdp=True),
        "square": dict(cfg=SQUARE, batches=SQUARE_BATCHES)}, device="cpu")


@pytest.fixture(scope="module")
def ranks4(jax_dp2_tp2):
    ref = jax_dp2_tp2
    return dryrun.compare_ranks(4, {
        "tp": dict(cfg=VIT, batches=BATCHES, tp=2),
        "tp_dropout": dict(cfg=VIT, batches=BATCHES, tp=2, dropout=0.1),
        "tp_fsdp": dict(cfg=VIT, batches=BATCHES, tp=2, fsdp=True),
        "attn_out": dict(cfg=dryrun.tiny_config(remat="attn_out"),
                         batches=BATCHES, tp=2, fsdp=True),
        "jax": dict(cfg=ref["cfg"], batches=BATCHES, tp=2,
                    state_dict=ref["state_dict"], aug=ref["aug"])}, device="cpu")


def _same_run(ours, ref, params=None):
    steps = len(ref["losses"])
    np.testing.assert_allclose(ours["losses"], ref["losses"], rtol=1e-5)
    theirs = ref["state"] if params is None else params
    names = [n for n in theirs if n in ours["state"]]
    assert len(names) == len(theirs)
    diffs = torch.cat([(ours["state"][n] - theirs[n].float()).abs().flatten()
                       for n in names])
    bound = 2 * LR * steps
    assert diffs.max().item() <= bound, diffs.max().item()
    assert diffs.quantile(0.99).item() <= 1e-3 * bound, diffs.quantile(0.99).item()


def test_dp2_equals_one_rank(ranks2, one_rank):
    _same_run(ranks2["dp"], one_rank["vit"])
    # the draws are the global batch's: dropout and drop path were on
    assert VIT["model"]["drop_path_rate"] > 0
    # a planted fault: no gradient sum over the data axis (each rank steps
    # on its slice's gradient) must fail the same bounds
    with pytest.raises(AssertionError):
        _same_run(ranks2["unsummed"], one_rank["vit"])


def test_dp2_equals_one_rank_with_class_weights(ranks2, one_rank):
    """The loss divides by the global batch's weights, not per rank."""
    _same_run(ranks2["weights"], one_rank["weights"])
    assert ranks2["weights"]["losses"] != ranks2["dp"]["losses"]


def test_fsdp_equals_dp(ranks2):
    # the patch embedding and the MLP weights reach 2^16 elements: sharded
    assert ranks2["fsdp"]["sharded"] == 5 and ranks2["dp"]["sharded"] == 0
    _same_run(ranks2["fsdp"], ranks2["dp"])


def test_unpinned_square_model_dp2_equals_one_rank(ranks2, one_rank):
    """BatchNorm under batch statistics reduces its sums over the ranks; the
    running statistics move as one device's (flax's update rule)."""
    ours, ref = ranks2["square"], one_rank["square"]
    stats = [n for n in ref["state"] if n.endswith(("running_mean", "running_var"))]
    assert stats
    for n in stats:
        torch.testing.assert_close(ours["state"][n], ref["state"][n],
                                   rtol=1e-5, atol=1e-6)
    _same_run(ours, ref)


def test_dp2_tp2_equals_one_rank(ranks4, one_rank):
    _same_run(ranks4["tp"], one_rank["vit"])
    # the backbone's dropouts on: the MLP's hidden dropout on the cut fc1
    # output draws one device's mask at the full width, then its columns
    _same_run(ranks4["tp_dropout"], one_rank["dropout"])
    assert ranks4["tp_dropout"]["losses"] != ranks4["tp"]["losses"]


def test_tp2_with_fsdp_equals_tp2(ranks4):
    # TP cuts the blocks' products (12 leaves); FSDP shards the patch
    # embedding, the one other leaf of 2^16 elements
    assert ranks4["tp_fsdp"]["tp_cut"] == ranks4["tp"]["tp_cut"] == 12
    assert ranks4["tp_fsdp"]["sharded"] == 1
    _same_run(ranks4["tp_fsdp"], ranks4["tp"])


def test_remat_attn_out_under_tp_and_fsdp_equals_one_rank(ranks4, one_rank):
    """``remat="attn_out"`` on TP-cut blocks that FSDP wraps (the block
    runs it inside its module call, so FSDP gathers its parameters): the
    function of one rank without remat."""
    _same_run(ranks4["attn_out"], one_rank["vit"])


def test_dp2_tp2_matches_jax_dp2_tp2(ranks4, jax_dp2_tp2):
    ref = jax_dp2_tp2
    _same_run(ranks4["jax"], {"losses": ref["losses"]}, params=ref["params"])


def test_tp_cuts_are_head_aligned_and_gather_back_bit_for_bit():
    model = build_model(VIT)
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    tp, heads, dh = 2, 4, 32
    layout = mesh.tp_layout(model, tp)
    assert set(layout) == {f"backbone.blocks.{i}.{leaf}" for i in range(2)
                           for leaf in ("attn.qkv.weight", "attn.qkv.bias",
                                        "attn.proj.weight", "mlp.fc1.weight",
                                        "mlp.fc1.bias", "mlp.fc2.weight")}
    name = "backbone.blocks.0.attn.qkv.weight"
    cuts = [mesh.tp_slice(full[name], layout[name], r, tp) for r in range(tp)]
    d = heads * dh
    for r, cut in enumerate(cuts):
        # rank r: the q, k and v rows of heads [r H/T, (r+1) H/T)
        rows = [part * d + h * dh + i for part in range(3)
                for h in range(r * heads // tp, (r + 1) * heads // tp)
                for i in range(dh)]
        assert torch.equal(cut, full[name][rows])
    for n, rule in layout.items():
        shards = [mesh.tp_slice(full[n], rule, r, tp) for r in range(tp)]
        assert torch.equal(mesh.tp_unslice(shards, rule), full[n])


def test_tp_leaves_attention_whole_where_heads_do_not_divide():
    """8 ranks on 12 heads: attention stays replicated (its kernels need
    whole heads) and the MLP (3072 wide) is cut, as JAX falls back per leaf."""
    with torch.device("meta"):
        model = build_model({"model": {"arch": "vit", "input_size": 64},
                             "training": {}})
    layout = mesh.tp_layout(model, 8)
    assert layout and not any(".attn." in n for n in layout)
    assert all(".mlp." in n for n in layout)
    assert mesh.fsdp_shard_dim((768, 3072), 8) == 1
    assert mesh.fsdp_shard_dim((768,), 8) is None  # below 2^16: replicated
