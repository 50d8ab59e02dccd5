"""voxelslam_tpu_torch — the PyTorch/CUDA port of `voxelslam_tpu`.

The odometry + local-BA pipeline (`pipeline.SlamPipeline`) runs on an
NVIDIA GPU with plain PyTorch ops, plus one hand-written CUDA kernel for
the voxel-moment accumulation (`ops.moments`, sources in `csrc/`). The
JAX package is the reference: every module here keeps its counterpart's
function names, and the `tests/test_torch_*.py` files hold each one
against it. This package imports nothing of JAX or of `voxelslam_tpu`.
"""

__version__ = "0.1.0"

# Geometry needs true f32 contractions: reduced-precision operands
# (TF32 here, bf16 on the TPU) quantize world coordinates to centimetres
# at 10 m range; the JAX package measured 0.80 m ATE with bf16 operands
# against 0.007 m at full precision (its __init__ sets "highest").
import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
