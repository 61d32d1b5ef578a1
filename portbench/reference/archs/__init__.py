"""The reference's architectures, one module each, found by the name that a
configuration gives as `arch` (`harness.arch_module`). Each module defines:

- `specs(**arch_kwargs)`: the parameter specifications (name, shape,
  init) under the program's state_dict names, for `models.make_weights`;
- `forward(p, x, fps_gen, dropout=True, **arch_forward_kwargs)`: the
  plain float32 forward pass of a parameter dict, (B, N, 9) -> (B, N,
  classes) logits;
- `forward_flops(B, N, **arch_kwargs)`: the matmul FLOPs of one forward
  pass, counted as `portbench/work.py` says.

The pieces that architectures share (`make_weights`, `batch_norm`,
`_mlp`, `_mlp_specs`) are in `portbench/reference/models.py`, the
selections in `portbench/reference/select.py`.
"""
