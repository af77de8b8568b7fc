"""Engine families. Ported so far:

* explicit — periodic leapfrog cycle (PIC_L.py main / pypic explicit intent)
* implicit — periodic CN-Picard energy-conserving engine (pypic.py)
"""

from . import explicit, implicit  # noqa: F401
