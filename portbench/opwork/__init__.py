"""The work of each traced op, one module each, named after the public
function of `pointseg_torch.ops` that it counts. The modules present are
the ops that a `--trace 1` run wraps in named profiler ranges
(`harness.traced_ops`); a name that the program does not have is left
unwrapped. Each module defines:

- `work(args) -> (operations, bytes)` of one forward call, from `args`:
  [(shape, itemsize), ...] of the call's tensor arguments and its
  integer and boolean arguments as they are, in call order;

and, for an op whose backward pass launches its own kernel outside the
forward call's range (autograd launches it from its own thread):

- `BACKWARD_KERNELS`: names that the backward kernels' names contain,
  whose device time is added to the op's;
- `backward_work(args) -> (operations, bytes)` of that backward pass.

Counts follow the rule of the port's kernel table: every input byte read
once, every output byte written once, and the arithmetic the op needs;
they do not depend on how the op is implemented.
"""
