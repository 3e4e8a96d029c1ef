"""The benchmark's harness: it finds a cell's configuration, traffic and
metrics by the names in ``BENCHMARK.json``, drives the program
(``r2l_tpu_torch``) through the traffic's driver, times the window, reads
the trace, and decides ``correct`` against the plain reference in
``benchmark/reference``."""
