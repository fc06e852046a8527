"""100 x (1 - the seconds the card ran any kernel, copy or fill / the traced
window's seconds), from the profiler's CUDA activity."""

from portbench.readers import device_idle_pct as read  # noqa: F401
