"""The harness's own code: finding a cell's files by name, the traffic
generator, the program's set-up, the measured window, the trace reduction
and the comparison with the reference."""
