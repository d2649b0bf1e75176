"""Hopfield autoassociative recall (the reference's
`backend/examples/hopfield/main.rs` and attractors doc-test)."""

import numpy as np

from spiking_neural_networks_jax import attractors


def main():
    patterns = attractors.generate_random_patterns(10, 10, 3, 0.5, seed=4)
    weights = attractors.generate_hopfield_network(patterns)
    lattice = attractors.DiscreteNeuronLattice(10, 10, weights)

    for n, pattern in enumerate(patterns):
        distorted = attractors.distort_pattern(pattern, 0.2, seed=5 + n)
        lattice.input_pattern_into_discrete_grid(distorted)
        lattice.iterate(10)
        recovered = (lattice.convert_to_bools() == pattern).all()
        print(f"pattern {n}: recovered={bool(recovered)}")


if __name__ == "__main__":
    main()
