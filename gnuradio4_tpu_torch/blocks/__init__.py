"""Block library of the port; importing it populates the global registry.
``ref_aliases`` comes last: its aliases name blocks of the other modules."""

from . import (acquisition, basic, channelizer, channels,  # noqa: F401
               digital, dsp_extras, electrical, equalizer, fileio, filter,
               fourier, ldpc, math, misc, monitor, rds, sdr, squelch,
               testing, uncertain, util_blocks)
from . import ref_aliases  # noqa: F401,E402
