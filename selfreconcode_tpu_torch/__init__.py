"""SelfRecon on PyTorch + CUDA: the per-subject avatar optimization of
`selfreconcode_tpu`, ported to one NVIDIA GPU.

The JAX package stays the reference; every module here keeps its
counterpart's name (``models/sdf.py``, ``engine/trainer.py``, ...) and is
held against it by the ``tests/test_torch_*.py`` parity tests.

  - models/  the three MLPs as ``nn.Module``s, the toy SMPL body and the
             LBS skinner
  - ops/     binning, the splat soft mask and its CUDA kernels (``csrc/``),
             trilinear lookup, octree sweep, marching cubes
  - render/  camera model
  - engine/  surface solve with its implicit-function-theorem gradient,
             losses, IGR pretraining, the training step and the trainer
  - data/    scene dataset, per-frame parameter bank, PNG codec
  - cli/     ``python -m selfreconcode_tpu_torch.cli.train``

Nothing here imports JAX; conversion of JAX parameters is numpy-only
(``interop.py``).
"""

__version__ = "0.1.0"
