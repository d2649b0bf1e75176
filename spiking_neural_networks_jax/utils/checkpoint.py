"""Checkpoint / resume for lattices and networks.

The reference has no serialization (SURVEY.md §5: "Checkpoint/resume:
none") — state *is* the lattice object.  Here the SoA state is a pytree, so
checkpointing is a flat `.npz` of arrays plus a small JSON header; every
runtime object (Lattice, SpikeTrainLattice, RewardModulatedLattice,
LatticeNetwork) round-trips losslessly.
"""

from __future__ import annotations

import json

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.graph import DenseGraph, SparseGraph, StencilGraph
from .transfer import device_put_state


def _npz_path(path):
    """np.savez appends '.npz' to extensionless paths; normalize so
    save/load agree on the filename."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def _flatten(prefix, mapping, out):
    for k, v in mapping.items():
        out[f"{prefix}{k}"] = np.asarray(v)


def _graph_arrays(graph, prefix, out, meta):
    if isinstance(graph, DenseGraph):
        meta[prefix] = {"kind": "dense"}
        out[f"{prefix}weights"] = np.asarray(graph.weights)
        out[f"{prefix}mask"] = np.asarray(graph.mask)
    elif isinstance(graph, SparseGraph):
        meta[prefix] = {"kind": "sparse", "n_pre": graph.n_pre,
                        "n_post": graph.n_post}
        out[f"{prefix}src"] = np.asarray(graph.src)
        out[f"{prefix}dst"] = np.asarray(graph.dst)
        out[f"{prefix}weights"] = np.asarray(graph.weights)
    elif isinstance(graph, StencilGraph):
        meta[prefix] = {"kind": "stencil",
                        "offsets": [list(o) for o in graph.offsets]}
        out[f"{prefix}weights"] = np.asarray(graph.weights)
        out[f"{prefix}mask"] = np.asarray(graph.mask)
    elif graph is None:
        meta[prefix] = {"kind": "none"}
    else:
        raise TypeError(f"cannot checkpoint graph {type(graph)}")


def _load_graph(prefix, data, meta):
    info = meta[prefix]
    if info["kind"] == "dense":
        return DenseGraph(jax.device_put(data[f"{prefix}weights"]),
                          jax.device_put(data[f"{prefix}mask"]))
    if info["kind"] == "sparse":
        return SparseGraph(jax.device_put(data[f"{prefix}src"]),
                           jax.device_put(data[f"{prefix}dst"]),
                           jax.device_put(data[f"{prefix}weights"]),
                           info["n_pre"], info["n_post"])
    if info["kind"] == "stencil":
        return StencilGraph([tuple(o) for o in info["offsets"]],
                            jax.device_put(data[f"{prefix}weights"]),
                            jax.device_put(data[f"{prefix}mask"]))
    return None


def save_lattice(lattice, path):
    """Checkpoint any single-lattice object (Lattice, SpikeTrainLattice,
    RewardModulatedLattice)."""
    out, meta = {}, {"rows": lattice.rows, "cols": lattice.cols,
                     "internal_clock": lattice.internal_clock,
                     "id": lattice.id}
    if getattr(lattice, "key", None) is not None:
        out["__key__"] = np.asarray(lattice.key)
    _flatten("state/", lattice.state, out)
    if getattr(lattice, "graph", None) is not None:
        _graph_arrays(lattice.graph, "graph/", out, meta)
    if getattr(lattice, "trace", None) is not None:
        _flatten("trace/", lattice.trace, out)
        meta["dopamine"] = float(lattice.dopamine)
    out["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(_npz_path(path), **out)


def load_lattice(lattice, path):
    """Restore a checkpoint into an existing lattice object (must have been
    populated with the same model)."""
    data = np.load(_npz_path(path))
    meta = json.loads(bytes(data["__meta__"]).decode())
    lattice.rows, lattice.cols = meta["rows"], meta["cols"]
    lattice.internal_clock = meta["internal_clock"]
    lattice.id = meta["id"]
    if "__key__" in data.files:
        lattice.key = jnp.asarray(data["__key__"])
    lattice.state = device_put_state(
        {k[len("state/"):]: data[k] for k in data.files
         if k.startswith("state/")})
    if "graph/" in meta:
        lattice.graph = _load_graph("graph/", data, meta)
    if any(k.startswith("trace/") for k in data.files):
        lattice.trace = device_put_state(
            {k[len("trace/"):]: data[k] for k in data.files
             if k.startswith("trace/")})
        lattice.dopamine = meta["dopamine"]
    return lattice


def save_network(network, path):
    out = {}
    meta = {"internal_clock": network.internal_clock,
            "electrical_synapse": network.electrical_synapse,
            "chemical_synapse": network.chemical_synapse,
            "lattices": {}, "spike_train_lattices": {}, "connections": [],
            "reward_lattices": {}, "reward_connections": []}
    for i, lat in getattr(network, "reward_modulated_lattices", {}).items():
        p = f"rlat{i}/"
        meta["reward_lattices"][str(i)] = {
            "rows": lat.rows, "cols": lat.cols,
            "internal_clock": lat.internal_clock,
            "dopamine": float(lat.dopamine)}
        _flatten(p + "state/", lat.state, out)
        _graph_arrays(lat.graph, p + "graph/", out, meta)
        _flatten(p + "trace/", lat.trace, out)
    for (pre, post), rconn in getattr(network,
                                      "reward_connections", {}).items():
        key = f"rconn{pre}_{post}/"
        meta["reward_connections"].append([pre, post, key])
        for name, arr in zip(("src", "dst", "w", "c", "dw", "counter"),
                             rconn):
            out[key + name] = np.asarray(arr)
    if hasattr(network, "dopamine"):
        meta["dopamine"] = float(network.dopamine)
    for i, lat in network.lattices.items():
        p = f"lat{i}/"
        meta["lattices"][str(i)] = {"rows": lat.rows, "cols": lat.cols,
                                    "internal_clock": lat.internal_clock}
        _flatten(p + "state/", lat.state, out)
        _graph_arrays(lat.graph, p + "graph/", out, meta)
    for i, st in network.spike_train_lattices.items():
        p = f"st{i}/"
        meta["spike_train_lattices"][str(i)] = {
            "rows": st.rows, "cols": st.cols,
            "internal_clock": st.internal_clock}
        _flatten(p + "state/", st.state, out)
    for (pre, post), (src, dst, w) in network.connections.items():
        key = f"conn{pre}_{post}/"
        meta["connections"].append([pre, post, key])
        out[key + "src"] = np.asarray(src)
        out[key + "dst"] = np.asarray(dst)
        out[key + "w"] = np.asarray(w)
    # the PRNG key drives every stochastic source (Poisson trains):
    # without it a resumed run cannot reproduce the original trajectory
    out["__key__"] = np.asarray(network.key)
    out["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(_npz_path(path), **out)


def load_network(network, path):
    data = np.load(_npz_path(path))
    meta = json.loads(bytes(data["__meta__"]).decode())
    network.internal_clock = meta["internal_clock"]
    network.electrical_synapse = meta["electrical_synapse"]
    network.chemical_synapse = meta["chemical_synapse"]
    if "__key__" in data.files:
        network.key = jnp.asarray(data["__key__"])
    for i_str, info in meta["lattices"].items():
        lat = network.lattices[int(i_str)]
        p = f"lat{i_str}/"
        lat.rows, lat.cols = info["rows"], info["cols"]
        lat.internal_clock = info["internal_clock"]
        lat.state = device_put_state(
            {k[len(p + "state/"):]: data[k] for k in data.files
             if k.startswith(p + "state/")})
        lat.graph = _load_graph(p + "graph/", data, meta)
    for i_str, info in meta["spike_train_lattices"].items():
        st = network.spike_train_lattices[int(i_str)]
        p = f"st{i_str}/"
        st.rows, st.cols = info["rows"], info["cols"]
        st.internal_clock = info["internal_clock"]
        st.state = device_put_state(
            {k[len(p + "state/"):]: data[k] for k in data.files
             if k.startswith(p + "state/")})
    for pre, post, key in meta["connections"]:
        network.connections[(pre, post)] = (
            data[key + "src"], data[key + "dst"], data[key + "w"])
    for i_str, info in meta.get("reward_lattices", {}).items():
        lat = network.reward_modulated_lattices[int(i_str)]
        p = f"rlat{i_str}/"
        lat.rows, lat.cols = info["rows"], info["cols"]
        lat.internal_clock = info["internal_clock"]
        lat.dopamine = info["dopamine"]
        lat.state = device_put_state(
            {k[len(p + "state/"):]: data[k] for k in data.files
             if k.startswith(p + "state/")})
        lat.graph = _load_graph(p + "graph/", data, meta)
        lat.trace = device_put_state(
            {k[len(p + "trace/"):]: data[k] for k in data.files
             if k.startswith(p + "trace/")})
    for pre, post, key in meta.get("reward_connections", []):
        network.reward_connections[(pre, post)] = tuple(
            data[key + name] for name in ("src", "dst", "w", "c", "dw",
                                          "counter"))
    if "dopamine" in meta:
        network.dopamine = meta["dopamine"]
    network._conn_version = getattr(network, "_conn_version", 0) + 1
    return network
