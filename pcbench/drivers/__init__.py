"""The benchmark's drivers, one a kind of loop: a mix names its driver."""
