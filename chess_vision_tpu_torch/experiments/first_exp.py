"""How often the first CPU ``torch.exp`` of a process differs from the next.

PyTorch's CPU build sets up its vector math lazily, on the first call in a
process. This starts ``--procs`` Python processes, ``--parallel`` at a time
(the load is part of it: the difference shows only on a busy host), and each
takes exp of the softmax arguments of ``tests/test_torch_int8_attention.py``'s
largest case (2 images, 257 tokens, 2 heads of 64; float32, on 2 threads)
three times: first thing, or after one small exp on one thread as importing
``chess_vision_tpu_torch.ops`` makes it (``--warm``). It prints how many
processes' first result differs from their later ones, and the largest
relative difference.

Usage:
  python -m chess_vision_tpu_torch.experiments.first_exp [--procs 80]
      [--parallel 8] [--warm]
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor


def child(warm: bool) -> dict:
    """One process's three exps (imports torch here: the parent must not
    have called exp before it starts its children)."""
    import numpy as np
    import torch

    if warm:
        import chess_vision_tpu_torch.ops  # noqa: F401  (its one small exp)
    torch.set_num_threads(2)
    B, N, H, Dh = 2, 257, 2, 64
    qkv = np.random.default_rng(N).normal(size=(B, N, 3 * H * Dh))
    qkv[:, :, :H * Dh] *= 4.0
    qkv = torch.from_numpy(qkv.astype(np.float32)).bfloat16()
    q, k, _ = qkv.reshape(B, N, 3, H, Dh).unbind(2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(Dh)
    x = s - s.amax(dim=-1, keepdim=True)
    first, later = torch.exp(x), [torch.exp(x) for _ in range(2)]
    ref = later[0].double()
    return {"later_agree": bool(torch.equal(later[0], later[1])),
            "first_differs": not torch.equal(first, later[0]),
            "max_rel": ((first.double() - ref).abs() / ref.clamp_min(1e-300))
            .max().item()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--procs", type=int, default=80)
    parser.add_argument("--parallel", type=int, default=8)
    parser.add_argument("--warm", action="store_true")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.warm)))
        return 0
    cmd = [sys.executable, "-m", __spec__.name, "--child",
           *(["--warm"] if args.warm else [])]

    def run(_):
        out = subprocess.run(cmd, capture_output=True, text=True, check=True)
        return json.loads(out.stdout.strip().splitlines()[-1])

    with ThreadPoolExecutor(args.parallel) as pool:
        results = list(pool.map(run, range(args.procs)))
    odd = [r for r in results if r["first_differs"]]
    print(json.dumps({
        "procs": args.procs, "parallel": args.parallel, "warm": args.warm,
        "first_call_differs": len(odd),
        "later_calls_agree": all(r["later_agree"] for r in results),
        "max_rel_diff": max((r["max_rel"] for r in odd), default=0.0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
