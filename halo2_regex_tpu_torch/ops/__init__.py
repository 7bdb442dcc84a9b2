"""Device ops of the port: the bitplane matcher (``bitplane``), the
table-driven split matcher (``pallas_scan``), their CUDA kernels
(``kernels``), run extraction (``extract``), the knob check and the numpy
oracle."""
