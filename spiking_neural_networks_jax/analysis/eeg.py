"""EEG power-spectral-density analysis and earth-mover's distance.

JAX rebuild of `reference/backend/src/eeg/` using `jnp.fft`
instead of rustfft.
"""

from __future__ import annotations

import jax.numpy as jnp


def get_power_density(x, dt, total_time):
    """`get_power_density` (eeg/mod.rs:15-46): mean-subtracted FFT power
    spectrum.  Returns (frequency axis, positive-half power spectrum).

    Sxx = 2 dt^2 / (N dt) * |X|^2, taken over [0, N/2); faxis = arange(0, fnq, 1/T).
    """
    x = jnp.asarray(x, jnp.float32)
    n = x.shape[0]
    x_fft = jnp.fft.fft(x - jnp.mean(x))
    sxx = (2.0 * dt ** 2 / (n * dt)) * (x_fft * jnp.conj(x_fft))
    sxx_positive = jnp.real(sxx[: n // 2])
    df = 1.0 / total_time
    fnq = 1.0 / (2.0 * dt)
    faxis = jnp.arange(0.0, fnq, df, dtype=jnp.float32)
    return faxis, sxx_positive


def earth_moving_distance(u_values, v_values, u_weights, v_weights):
    """`earth_moving_distance` (eeg/emd/mod.rs:55-120), the scipy
    `wasserstein_distance` construction: CDF difference integrated over the
    merged support."""
    u_values = jnp.asarray(u_values, jnp.float32)
    v_values = jnp.asarray(v_values, jnp.float32)
    u_weights = jnp.asarray(u_weights, jnp.float32)
    v_weights = jnp.asarray(v_weights, jnp.float32)

    u_sorter = jnp.argsort(u_values)
    v_sorter = jnp.argsort(v_values)
    all_values = jnp.sort(jnp.concatenate([u_values, v_values]))
    deltas = jnp.diff(all_values)

    u_sorted = u_values[u_sorter]
    v_sorted = v_values[v_sorter]
    # 'right' searchsorted over the merged support minus its last element
    u_idx = jnp.searchsorted(u_sorted, all_values[:-1], side="right")
    v_idx = jnp.searchsorted(v_sorted, all_values[:-1], side="right")

    u_cum = jnp.concatenate([jnp.zeros(1), jnp.cumsum(u_weights[u_sorter])])
    v_cum = jnp.concatenate([jnp.zeros(1), jnp.cumsum(v_weights[v_sorter])])
    u_cdf = u_cum[u_idx] / u_cum[-1]
    v_cdf = v_cum[v_idx] / v_cum[-1]

    return jnp.sum(jnp.abs(u_cdf - v_cdf) * deltas)


def power_density_comparison(sxx1, sxx2):
    """`power_density_comparison` (eeg/mod.rs:55-74): EMD between max-scaled
    spectra, rescaled by the squared peak-height difference."""
    sxx1 = jnp.asarray(sxx1, jnp.float32)
    sxx2 = jnp.asarray(sxx2, jnp.float32)
    if sxx1.shape != sxx2.shape:
        raise ValueError("series are not the same length")
    values = jnp.arange(sxx1.shape[0], dtype=jnp.float32)
    u_max = jnp.max(sxx1)
    v_max = jnp.max(sxx2)
    emd = earth_moving_distance(values, values, sxx1 / u_max, sxx2 / v_max)
    return emd * (u_max - v_max) ** 2
