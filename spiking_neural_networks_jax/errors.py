"""Error taxonomy.

Named exception types mirroring the reference's error enums
(`reference/backend/src/error/mod.rs`): `GraphError` (:16),
`LatticeNetworkError` (:44), `PatternError` (:107), `GeneticAlgorithmError`
(:126), `TimeSeriesProcessingError` (:168), `ReceptorNeurotransmitterError`
(:187), `AgentError` (:206), with `SpikingNeuralNetworksError` (:263) as the
umbrella base.
"""


class SpikingNeuralNetworksError(Exception):
    """Umbrella error type."""


class GraphError(SpikingNeuralNetworksError, ValueError):
    """Position not found / dimension mismatches in graphs."""


class LatticeNetworkError(SpikingNeuralNetworksError, ValueError):
    """Network structure violations (id collisions, spike-train postsynaptic)."""


class PatternError(SpikingNeuralNetworksError, ValueError):
    """Hopfield pattern dimension mismatches."""


class GeneticAlgorithmError(SpikingNeuralNetworksError, ValueError):
    """GA configuration / objective failures."""


class TimeSeriesProcessingError(SpikingNeuralNetworksError, ValueError):
    """Series length mismatches in analysis utilities."""


class ReceptorNeurotransmitterError(SpikingNeuralNetworksError, ValueError):
    """Mismatched receptor / neurotransmitter types."""


class AgentError(SpikingNeuralNetworksError, RuntimeError):
    """Agent iteration failures in the RL environment."""
