"""CPU tests of the benchmark (and its card tests, marked ``cuda``)."""
