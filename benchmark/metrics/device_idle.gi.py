"""device_idle.gi: ``device_idle.frame``, read alike, in the cells whose
frame time is held per layer (``frame_s.gi``); it moves ``setup_s``
there, through the warm-up frame."""

import os

from benchmark import core

_SAME = core.reader(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "device_idle.frame")
read = _SAME.read
