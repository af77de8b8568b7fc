"""Particle pushers. Ported so far: leapfrog, Crank-Nicolson and
Boris-Buneman (the guiding-center pusher comes with the magnetized
stack's next slice).
"""

from .boris import boris_push_dt  # noqa: F401
from .leapfrog import leapfrog_push, cn_push  # noqa: F401
