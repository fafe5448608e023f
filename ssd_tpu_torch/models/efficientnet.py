"""EfficientNet-lite feature extractor (MBConv without squeeze-excite).

Counterpart of ``ssd_tpu/models/efficientnet.py``: the EfficientNet-lite0
schedule (Tan & Le 2019, "lite": no squeeze-excite, ReLU6) on MobileNet-v2's
``InvertedResidual`` with 3x3 and 5x5 depthwise kernels. The stem stays at
32 channels and the last stage at 320 for every ``width_multiplier``, as in
the published lite schedules. A 5x5 stride-2 SAME depthwise conv pads (1,
2) on an even input (``layers.Conv``).
"""

from __future__ import annotations

from ssd_tpu_torch.constants import BATCH_NORM_MOMENTUM
from ssd_tpu_torch.models.mobilenet_v2 import InvertedResidualNet, _width

# (expand, out_ch, num_blocks, first_stride, dw_kernel): EfficientNet-lite0
_SCHEDULE = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),    # /4
    (6, 40, 2, 2, 5),    # /8  -> c3
    (6, 80, 3, 2, 3),    # /16
    (6, 112, 3, 1, 5),   #     -> c4
    (6, 192, 4, 2, 5),   # /32
    (6, 320, 1, 1, 3),   #     -> c5
)


class EfficientNetLite(InvertedResidualNet):
    def __init__(self, width_multiplier: float = 1.0,
                 bn_momentum: float = BATCH_NORM_MOMENTUM,
                 norm: str = "batch", stem_stride: int = 2,
                 int8: bool = False):
        last = len(_SCHEDULE) - 1
        schedule = tuple(
            (t, 320 if gi == last else _width(c, width_multiplier), n, s, k)
            for gi, (t, c, n, s, k) in enumerate(_SCHEDULE))
        super().__init__(32, schedule, bn_momentum, norm, stem_stride, int8)
