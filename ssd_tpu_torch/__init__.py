"""PyTorch/CUDA port of ``ssd_tpu`` for NVIDIA Hopper.

The package mirrors ``ssd_tpu/``'s layout so each module's counterpart is
found at the same path. It imports ``torch`` and numpy only. It serves
(``predictor.py``) and trains (``train.py``). Its three hand-written
kernels, class-wise greedy NMS (``csrc/nms.cu``), anchor matching
(``csrc/match.cu``) and the fused ds1+ds2 blocks of the reference schedule
(``csrc/fused_early.cu``), are built with ``nvcc`` at first use
(``_build.py``); on CPU tensors every wrapper runs its plain PyTorch
version instead.
"""
