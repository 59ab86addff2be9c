"""The benchmark's core: it names no model. It reads a cell from
``BENCHMARK.json``, loads the configuration's module, the traffic mix's
data file and the metrics' readers by name, runs the cell on one or
several cards, and prints the result line."""
