"""k2_fused_shadow_roofline.gi: ``k2_fused_shadow_roofline``, read
alike, in the cells whose frame time is held per layer
(``frame_s.gi``); it moves ``setup_s`` there, through the warm-up
frame."""

import os

from benchmark import core

_SAME = core.reader(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "k2_fused_shadow_roofline")
WRAPS, read = _SAME.WRAPS, _SAME.read
