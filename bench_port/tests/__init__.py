"""CPU tests of the benchmark; card cases carry the ``gpu`` marker."""
