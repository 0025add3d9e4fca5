"""Lattice operators: semiring primitives, the FCC and FAC lattices, decoding."""
