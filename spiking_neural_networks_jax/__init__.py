"""spiking_neural_networks_jax — a spiking neural network simulator in JAX.

A ground-up JAX/XLA rebuild of the capabilities of the reference Rust
crate `spiking_neural_networks` (NikhilMukraj/spiking-neural-networks):
biological neuron models (integrate-and-fire family, Izhikevich,
Hodgkin-Huxley, Morris-Lecar) with neurotransmitter and receptor kinetics,
2-D lattices with electrical (gap junction) and chemical synapses,
multi-lattice networks fed by spike-train generators, plasticity (STDP, BCM,
reward-modulated STDP), Hopfield attractors, EEG/PSD analysis, genetic
algorithm fitting, and an RL environment wrapper — all as struct-of-arrays
state pytrees advanced by fused, jit-compiled step functions under
`lax.scan`, sharded across devices with `jax.sharding` / `shard_map`.  The
electrical Izhikevich lattice also has a CUDA kernel for NVIDIA Hopper
GPUs (ops/stencil_kernel.py).
"""

__version__ = "0.1.0"

from .models.integrate_and_fire import (
    LeakyIntegrateAndFire,
    QuadraticIntegrateAndFire,
    AdaptiveLeakyIntegrateAndFire,
    AdaptiveExpLeakyIntegrateAndFire,
    Izhikevich,
    LeakyIzhikevich,
    BCMIzhikevich,
    SimpleLeakyIntegrateAndFire,
)
from .models.hodgkin_huxley import HodgkinHuxley
from .models.morris_lecar import MorrisLecar
from .models.dopa import DopaIzhikevich
from .models.spike_train import (
    PoissonSpikeTrain,
    RateSpikeTrain,
    PresetSpikeTrain,
    BCMPoissonSpikeTrain,
)
from .core.lattice import Lattice
from .core.network import SpikeTrainLattice, LatticeNetwork
from .core.reward import RewardModulatedLattice
from .core.reward_network import RewardModulatedLatticeNetwork
from .interactable import Environment, UnsupervisedEnvironment
from . import coupling
from . import errors
from .core.plasticity import STDP, BCM, RewardModulatedSTDP
from .core import history
from .ops.graph import DenseGraph, SparseGraph, StencilGraph, radius_offsets
from .ops.receptors import IonotropicReceptors, DopaGluGABAReceptors
from . import attractors, analysis, fitting
from .ops.stencil_kernel import why_not as why_not_kernel
