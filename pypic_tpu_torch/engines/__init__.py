"""Engine families. Ported so far:

* explicit — periodic leapfrog cycle (PIC_L.py main / pypic explicit intent)
* implicit — periodic CN-Picard energy-conserving engine (pypic.py)
* magnetized — Boltzmann-electron magnetized sheath, Dirichlet-Dirichlet
  walls, Boris push, source re-activation (pygcpic.py pic_iead)
"""

from . import explicit, implicit, magnetized  # noqa: F401
