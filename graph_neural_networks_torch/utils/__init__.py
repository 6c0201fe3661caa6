"""Host-side helpers: graph math, devices, parameter transplant."""
