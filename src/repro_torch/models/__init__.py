"""Model code of the port: parameters, layers, stacks, top-level API."""
