"""Particle pushers: leapfrog, Crank-Nicolson, Boris-Buneman and the
guiding-center RK4 with its 6D <-> GC transforms."""

from .boris import boris_push_dt  # noqa: F401
from .guiding_center import (from_guiding_center, gc_push_rk4,  # noqa: F401
                             to_guiding_center)
from .leapfrog import leapfrog_push, cn_push  # noqa: F401
