"""STDP-coupled lattice driven by Poisson input (the reference's
`backend/examples/stdp/main.rs`): weight trajectories under plasticity."""

import numpy as np

import spiking_neural_networks_jax as snn


def main():
    lat = snn.Lattice(snn.Izhikevich(), id=0)
    lat.populate(5, 5, gap_conductance=10.0)
    lat.connect_stencil(radius=1.5, seed=1)
    lat.do_plasticity = True
    lat.plasticity = snn.STDP()
    lat.update_graph_history = True

    st = snn.SpikeTrainLattice(snn.PoissonSpikeTrain(), id=1)
    st.populate(5, 5)
    st.state = st.model.init_from_firing_rate(25, hertz=50.0, dt=0.1)

    net = snn.LatticeNetwork.generate_network([lat], [st])
    net.connect(1, 0, lambda x, y: x == y, lambda x, y: 3.0)
    net.run_lattices(2000)

    w = np.asarray(net.get_lattice(0).graph.weights)
    src, dst, wc = net.connections[(1, 0)]
    print(f"intra weights now in [{w.min():.2f}, {w.max():.2f}]; "
          f"input weights in [{wc.min():.2f}, {wc.max():.2f}]")


if __name__ == "__main__":
    main()
