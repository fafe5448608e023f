"""PyTorch/CUDA port of ``ssd_tpu`` for NVIDIA Hopper.

The package mirrors ``ssd_tpu/``'s layout so each module's counterpart is
found at the same path. It imports ``torch`` and numpy only. It serves
(``predictor.py``) and trains (``train.py``). Its two hand-written kernels,
class-wise greedy NMS (``csrc/nms.cu``) and anchor matching
(``csrc/match.cu``), are built with ``nvcc`` at first use (``_build.py``);
on CPU tensors every wrapper runs its plain PyTorch version instead.
"""
