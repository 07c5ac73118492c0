"""Block library of the port; importing it populates the global registry."""

from . import (basic, channelizer, filter, fourier, math, sdr,  # noqa: F401
               testing)
