"""Block library of the port; importing it populates the global registry.
``ref_aliases`` comes last: its aliases name blocks of the other modules."""

from . import (acquisition, ais, ax25, basic, ble,  # noqa: F401
               channelizer, channels, cw, digital, dsp_extras, electrical,
               equalizer, fec, fileio, filter, fourier, ldpc, lora, math,
               misc, monitor, rds, rtty, same, sdr, squelch, sstv, testing,
               uncertain, util_blocks, wifi)
from . import ref_aliases  # noqa: F401,E402
