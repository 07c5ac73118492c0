"""Block library of the port; importing it populates the global registry.
``ref_aliases`` comes last: its aliases name blocks of the other modules."""

from . import (basic, channelizer, channels, digital, dsp_extras,  # noqa: F401
               equalizer, fileio, filter, fourier, ldpc, math, misc, monitor,
               rds, sdr, squelch, testing, util_blocks)
from . import ref_aliases  # noqa: F401,E402
