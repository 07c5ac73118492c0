"""Block library of the port; importing it populates the global registry."""

from . import basic, filter, fourier, sdr, testing  # noqa: F401
