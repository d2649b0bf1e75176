"""Epsilon-greedy linear-trend parameter search over simulation objectives.

Implements the algorithm sketched (entirely in comments) in
`/root/reference/interface/experiments/heuristic_parameter_search.py`:

* keep an ``analysis`` map of parameter vector -> score;
* per parameter, fit the linear trend of score vs value over the
  history and assume it continues;
* move each parameter in the direction that brings the predicted score
  closer to the target, weighted by how correlated the trend is;
* with probability epsilon take a random exploration step instead
  (the note's "epsilon greedy algo").

The demo objective tunes a small Izhikevich lattice's mean firing rate to
a target by searching (input current scale, gap conductance) — cheap
enough for CI while exercising the whole search loop.  `heuristic_search`
itself is generic: pass any ``objective(params) -> score`` with bounds.

Usage:
    python experiments/heuristic_parameter_search.py [--target N]
        [--search-iterations N]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from pipeline_setup import output_path

import spiking_neural_networks_jax.lixirnet as ln


def linear_trend(xs, ys):
    """Slope + Pearson correlation of score vs parameter value (the note's
    LinearRegression + pearsonr pair).  Returns (slope, r)."""
    xs, ys = np.asarray(xs, float), np.asarray(ys, float)
    if len(xs) < 2 or np.ptp(xs) == 0 or np.ptp(ys) == 0:
        return 0.0, 0.0
    slope = np.polyfit(xs, ys, 1)[0]
    r = float(np.corrcoef(xs, ys)[0, 1])
    return float(slope), (0.0 if np.isnan(r) else r)


def heuristic_search(objective, bounds, target, iterations=20,
                     epsilon=0.25, initial_samples=4, step_frac=0.15,
                     rng=None):
    """Minimize |objective(params) - target| via epsilon-greedy
    trend-following.  ``bounds`` is {name: (lo, hi)}.  Returns
    (best_params, best_score, analysis trace)."""
    rng = rng or np.random.default_rng()
    names = list(bounds)
    lo = np.array([bounds[k][0] for k in names])
    hi = np.array([bounds[k][1] for k in names])
    span = hi - lo

    analysis = []      # (param vector, score) pairs — the note's `analysis`

    def sample(vec):
        params = dict(zip(names, vec))
        score = objective(params)
        analysis.append((list(map(float, vec)), float(score)))
        return score

    # gather random data first ("need to first gather random data and then
    # use heuristic")
    for _ in range(initial_samples):
        sample(lo + rng.random(len(names)) * span)

    for _ in range(iterations):
        vecs = np.array([v for v, _ in analysis])
        scores = np.array([s for _, s in analysis])
        best_i = int(np.argmin(np.abs(scores - target)))
        current = vecs[best_i].copy()
        if rng.random() < epsilon:            # exploration step
            current = lo + rng.random(len(names)) * span
        else:                                 # heuristic trend step
            err = target - scores[best_i]
            for d in range(len(names)):
                slope, r = linear_trend(vecs[:, d], scores)
                if slope == 0.0:
                    continue
                # move in the direction the linear trend says closes the
                # gap, scaled by trend confidence |r|
                current[d] += np.clip(err / slope, -step_frac * span[d],
                                      step_frac * span[d]) * abs(r)
            current = np.clip(current, lo, hi)
        sample(current)

    scores = np.array([s for _, s in analysis])
    best_i = int(np.argmin(np.abs(scores - target)))
    best = dict(zip(names, analysis[best_i][0]))
    return best, float(scores[best_i]), analysis


def firing_rate_objective(params, rows=6, cols=6, iterations=400, seed=7):
    """Mean spikes per neuron of a Poisson-driven Izhikevich lattice — a
    cheap objective, monotone in both knobs (drive rate and drive
    weight), so the linear-trend heuristic has a gradient to follow."""
    rng = np.random.default_rng(seed)
    lat = ln.IzhikevichNeuronLattice(0)
    lat.populate(ln.IzhikevichNeuron(), rows, cols)
    lat.connect_stencil(radius=1.5, keep_prob=0.8, seed=seed)
    lat.apply(lambda n: setattr(
        n, "current_voltage", float(rng.uniform(-65, -55))) or n)
    lat.update_grid_history = True

    drive = ln.PoissonLattice(1)
    drive.populate(ln.PoissonNeuron(), rows, cols)
    drive.apply(lambda n: setattr(
        n, "chance_of_firing", float(params["drive_rate"])) or n)

    net = ln.IzhikevichNeuronNetwork.generate_network([lat], [drive])
    in_degree = float(rows * cols + 1)
    net.connect(1, 0, lambda x, y: x == y,
                lambda x, y: in_degree * float(params["drive_weight"]))
    net.set_dt(1.0)
    net.run_lattices(iterations)
    hist = np.stack(lat.history)
    return float((hist >= 29.0).sum() / (rows * cols))


def main(target=20.0, search_iterations=15, seed=3):
    rng = np.random.default_rng(seed)
    bounds = dict(drive_rate=(0.0, 0.2), drive_weight=(0.0, 3.0))
    best, score, analysis = heuristic_search(
        firing_rate_objective, bounds, target,
        iterations=search_iterations, rng=rng)
    out = dict(target=target, best_params=best, best_score=score,
               n_evaluations=len(analysis),
               trace=[dict(params=v, score=s) for v, s in analysis])
    path = output_path("heuristic_search_output.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"heuristic search: target {target}, best score {score:.2f} at "
          f"{ {k: round(v, 2) for k, v in best.items()} } "
          f"after {len(analysis)} evaluations; saved {path}")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--target", type=float, default=20.0)
    p.add_argument("--search-iterations", type=int, default=15)
    a = p.parse_args()
    main(target=a.target, search_iterations=a.search_iterations)
