"""The benchmark's yardstick: cells by name, inputs from the seed, the
window, the traces and the check."""
