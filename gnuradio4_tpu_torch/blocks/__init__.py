"""Block library of the port; importing it populates the global registry.
``ref_aliases`` comes last: its aliases name blocks of the other modules."""

from . import (acquisition, adsb, ais, apt, ax25, basic, ble,  # noqa: F401
               ccsds, channelizer, channels, cw, dcf77, digital, dsp_extras,
               electrical, equalizer, fec, fileio, filter, fourier, gnss,
               ieee802154, ldpc, lora, math, misc, monitor, pocsag, polar,
               python_block, rds, reed_solomon, rtty, same, sdr, squelch,
               sstv, testing, timing, uncertain, util_blocks, vocoder, wefax,
               wifi)
from . import ref_aliases  # noqa: F401,E402
