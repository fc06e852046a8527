"""100 x (the least bytes of the window's jobs over 3.35 TB/s) / the summed
device time of every kernel of the window, whatever its name."""

from portbench.readers import kernels_roofline as read  # noqa: F401
