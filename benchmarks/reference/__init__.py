"""Plain PyTorch references of the benchmark's configurations, in f32: one
module per architecture (``param_spec``, ``forward``, ``work``) and the
training step (``train``). They import nothing of the program under test."""
