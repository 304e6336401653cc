"""The yardstick: peaks, operation counts, trace and statistics arithmetic.
Frozen with the benchmark, so that later changes to the program cannot move
it."""
