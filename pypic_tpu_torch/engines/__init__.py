"""Engine families. Ported so far:

* explicit — periodic leapfrog cycle (PIC_L.py main / pypic explicit intent)
* implicit — periodic CN-Picard energy-conserving engine (pypic.py)
* magnetized — Boltzmann-electron magnetized sheath (pygcpic.py pic_iead,
  pic_bca_aps, dirichlet_neumann_test): Boris and guiding-center pushers,
  ionization, the sources, wall-impact rows and the BCA escape
* bca_driver — the hybrid PIC <-> surface-model loop (pic_bca_aps)
* sheath — bounded two-species implicit sheath with absorbing walls,
  thermostat and re-injection (PIC_L_DD.py main_i)
"""

from . import explicit, implicit, magnetized, sheath  # noqa: F401
