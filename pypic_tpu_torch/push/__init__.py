"""Particle pushers. Ported so far: leapfrog and Crank-Nicolson (the
Boris-Buneman and guiding-center pushers come with the magnetized engine).
"""

from .leapfrog import leapfrog_push, cn_push  # noqa: F401
