"""The port's counterparts of the repository's ``benchmarks/`` drivers."""
