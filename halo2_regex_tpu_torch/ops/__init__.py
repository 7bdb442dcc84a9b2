"""Device ops of the port: the bitplane matcher (``bitplane``), its CUDA
kernels (``kernels``), run extraction (``extract``), the knob check and
the numpy oracle."""
