"""Block library of the port; importing it populates the global registry."""

from . import (basic, channelizer, dsp_extras, fileio, filter,  # noqa: F401
               fourier, ldpc, math, misc, sdr, testing)
