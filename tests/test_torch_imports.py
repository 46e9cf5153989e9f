"""The port stands alone: no module of ``chess_vision_tpu_torch`` and not
``chip_smoke.py`` imports the JAX package, jax, flax or optax, and importing
the port's entry modules loads none of them. The port's own copies of the
JAX package's numpy-only modules are held equal to the originals: ``fen`` on
the cases of ``tests/test_fen.py``, the data-config table, the loader's batch
order."""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

import chess_vision_tpu.config as jax_config
import chess_vision_tpu.data as jax_data
import chess_vision_tpu.fen as jax_fen
import chess_vision_tpu_torch.config as port_config
import chess_vision_tpu_torch.data as port_data
import chess_vision_tpu_torch.fen as port_fen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("chess_vision_tpu", "jax", "jaxlib", "flax", "optax")
ENTRY_MODULES = (
    "chess_vision_tpu_torch", "chess_vision_tpu_torch.serve",
    "chess_vision_tpu_torch.predict", "chess_vision_tpu_torch.train.__main__",
    "chess_vision_tpu_torch.data", "chess_vision_tpu_torch.native",
    "chess_vision_tpu_torch.augment", "chess_vision_tpu_torch.utils.logging",
    "chess_vision_tpu_torch.experiments.attn_variants",
)
START = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR"
FENS = [START, "8/8/8/8/8/8/8/8", "k7/8/8/8/8/8/8/7K",
        "r1bq1rk1/pp2bppp/2n2n2/2pp4/8/1P1P1NP1/PBPN1PBP/R2Q1RK1",
        "1B1B1K2/3p1N2/8/8/8/8/8/1B6", "8/2Q5/8/8/8/8/qqq5/K6k"]


def _port_sources():
    files = glob.glob(os.path.join(ROOT, "chess_vision_tpu_torch", "**", "*.py"),
                      recursive=True)
    return sorted(files) + [os.path.join(ROOT, "chip_smoke.py")]


def test_no_source_imports_the_jax_package_or_jax():
    files = _port_sources()
    assert len(files) > 25
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(os.path.relpath(path, ROOT), node.lineno, name)
                    for name in names if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_loads_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {ENTRY_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print('LOADED', bad)\n"
    )
    # -S -E would drop the site's packages; the interpreter's start-up may
    # itself load jax here, so the child reports what the imports add
    probe = "import sys; print(sorted(m for m in sys.modules if m.split('.')[0] in %r))" % (FORBIDDEN,)
    before = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                            capture_output=True, text=True, check=True).stdout
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = out.stdout.strip().splitlines()[-1]
    assert loaded == "LOADED " + before.strip(), (loaded, before)
    assert "chess_vision_tpu'" not in loaded and "'flax'" not in loaded
    assert "'optax'" not in loaded


def _assert_fen_constants_equal():
    for name in ("PIECE_TO_INDEX", "INDEX_TO_PIECE", "NUM_CLASSES",
                 "NUM_SQUARES", "NUM_PIECE_TYPES", "NUM_PIECE_COLORS"):
        assert getattr(port_fen, name) == getattr(jax_fen, name), name
    np.testing.assert_array_equal(port_fen.CLASS_TO_TYPE, jax_fen.CLASS_TO_TYPE)
    np.testing.assert_array_equal(port_fen.CLASS_TO_COLOR, jax_fen.CLASS_TO_COLOR)


@pytest.mark.parametrize("fen", FENS)
def test_fen_codec_equal(fen):
    labels = port_fen.fen_to_labels(fen)
    np.testing.assert_array_equal(labels, jax_fen.fen_to_labels(fen))
    assert labels.dtype == jax_fen.fen_to_labels(fen).dtype
    assert port_fen.labels_to_fen(labels) == jax_fen.labels_to_fen(labels) == fen
    assert port_fen.flip_fen(fen) == jax_fen.flip_fen(fen)
    name = fen.replace("/", "-") + ".jpeg"
    assert port_fen.filename_to_fen(name) == jax_fen.filename_to_fen(name) == fen


def test_fen_constants_parse_and_assemble_equal():
    _assert_fen_constants_equal()
    rng = np.random.default_rng(0)
    for fen in (START + " b KQkq -", START, START + " w Kq e3 0 1"):
        ours, theirs = port_fen.parse_full_fen(fen), jax_fen.parse_full_fen(fen)
        assert ours.keys() == theirs.keys()
        for key in ours:
            np.testing.assert_array_equal(ours[key], theirs[key])
            assert ours[key].dtype == theirs[key].dtype
    with pytest.raises(ValueError):
        port_fen.fen_to_labels("8/8/8")
    labels = rng.integers(0, 13, size=(50, 64)).astype(np.int32)
    turn = rng.normal(size=(50, 1))
    castling = rng.normal(size=(50, 4))
    assert port_fen.assemble_fens_batch(labels, turn, castling) == \
        jax_fen.assemble_fens_batch(labels, turn, castling)
    assert [port_fen.assemble_fen(l, t[0], c) for l, t, c in zip(labels, turn, castling)] == \
        [jax_fen.assemble_fen(l, t[0], c) for l, t, c in zip(labels, turn, castling)]


def test_config_and_loader_order_equal():
    """The data-config table, the override rules, the split and the loader's
    seed -> batch order are the JAX package's."""
    for name in (*jax_config._DATA_CFGS, "vit_other", "something_else"):
        assert port_config.get_data_config(name) == jax_config.get_data_config(name)
    a = {"x": {"i": 1, "f": 1.0, "b": True, "n": None, "s": "a"}}
    b = {"x": dict(a["x"])}
    overrides = ["x.i=3", "x.f=2", "x.b=false", "x.n=7", "x.s=zz"]
    port_config.apply_overrides(a, overrides)
    jax_config.apply_overrides(b, overrides)
    assert a == b
    for ours, theirs in zip(port_data.seeded_split(37, 0.2), jax_data.seeded_split(37, 0.2)):
        np.testing.assert_array_equal(ours, theirs)

    class Corpus:
        def labels_for(self, i):
            return {"squares": np.full(64, i % 13, np.int32),
                    "turn": np.zeros(1, np.float32),
                    "castling": np.zeros(4, np.float32),
                    "legal": np.ones(1, np.float32)}

        def load_image(self, i):
            return np.full((4, 4, 3), i, np.uint8)

    for epoch_count in (1, 2):
        loaders = [mod.BatchLoader(Corpus(), np.arange(21), 4, shuffle=True,
                                   seed=5, num_workers=1)
                   for mod in (port_data, jax_data)]
        for _ in range(epoch_count):
            batches = [list(loader) for loader in loaders]
        assert len(batches[0]) == len(batches[1]) == 6
        for ours, theirs in zip(*batches):
            assert ours.keys() == theirs.keys()
            for key in ("indices", "image", "squares", "mask"):
                np.testing.assert_array_equal(ours[key], theirs[key])
