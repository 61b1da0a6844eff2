"""The benchmark's plain reference: neighbor search, descriptors, network,
forces, virial and one MD step, in float64 plain torch. It imports nothing
of the program."""
