"""Device ops of the port: each holds a hand-written CUDA kernel and the plain
PyTorch version it is tested against.

Importing the package makes one small call of torch's CPU exp, which runs on
the calling thread alone. PyTorch's CPU build sets up its vector math (exp,
erf and the like) lazily, on the first such call in a process; when that first
call is split over several threads, one thread's share can come from another
code path, up to ~1e-4 relative off, and only under load, so in some
processes and not others. The plain versions round p to bf16 right after
their exp, so such a first call moves their int8 codes by a level where the
JAX package's do not. A first call on one thread sets the vector math up
before any call is split.
"""

import torch as _torch

_torch.exp(_torch.zeros(8))
