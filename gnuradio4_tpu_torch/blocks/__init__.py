"""Block library of the port; importing it populates the global registry.
``ref_aliases`` comes last: its aliases name blocks of the other modules.
The hardware backends register where their system library loads (``alsa``:
libasound, ``soapy``: libSoapySDR) and the ZeroMQ blocks where pyzmq imports."""

from . import (acquisition, adsb, ais, alsa, apt, audio, ax25,  # noqa: F401
               basic, ble, ccsds, channelizer, channels, cw, dcf77, digital,
               dsp_extras, electrical, equalizer, fec, fileio, filter,
               fourier, gnss, http, ieee802154, ldpc, lora, math, misc,
               monitor, network, pocsag, polar, python_block, rds,
               reed_solomon, rtl2832, rtty, same, sdr, sigmf, soapy, squelch,
               sstv, testing, timing, uncertain, uri, usb, util_blocks,
               vocoder, wefax, wifi, zeromq)
from . import ref_aliases  # noqa: F401,E402
