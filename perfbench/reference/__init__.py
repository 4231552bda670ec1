"""The benchmark's plain reference: a frozen copy of the plain PyTorch code
of the DG detectors (models, ops, the pair step and the optimizers), taken
from the port at the commit that added the benchmark, so that later changes
to the program cannot move it. It imports nothing of the program, of JAX or
of the JAX package.

Departures from the copied code, each marked where it is made:
- every op takes its plain version on every device (RoIAlign, the RPN's
  decode and NMS, the IoU and FCOS matchers, the first-k NMS): no kernel;
- the initialisers record each leaf's standard deviation and draw nothing
  (`models/layers.py`); perfbench/bench/models.py::make_state makes the
  weights;
- Conv and Dense round their operands to float8 e4m3 where `fp8` is set on
  them (the precision control);
- `train/steps.py::_half` logs each half's gradient norms per leaf where the
  model carries a `grad_log` list.
Docstrings that name a kernel describe the copied function's original.
"""
