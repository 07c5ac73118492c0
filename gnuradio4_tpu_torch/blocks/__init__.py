"""Block library of the port; importing it populates the global registry."""

from . import (basic, channelizer, fileio, filter, fourier, ldpc,  # noqa: F401
               math, sdr, testing)
