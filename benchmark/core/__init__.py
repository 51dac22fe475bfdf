"""The harness: inputs from the seed, the entries that drive the port,
the yardstick, the trace reader and the checks."""
