"""Device ops of the port: the bitplane witness pipeline (``bitplane``),
its CUDA kernels (``kernels``), the knob check and the numpy oracle."""
