"""Closed-form ridge regression of the full state-transition operator.

The reference's supervised-ML operator accepts any scikit-learn-protocol
regressor (/root/reference/pararealml/operators/ml/supervised/
supervised_ml_operator.py:238-284 calls plain ``fit``/``predict``/
``score``; its Keras wrapper exists to give neural nets that protocol,
sklearn_keras_regressor.py:13-214). This module supplies the protocol's
classical baseline as a first-class JAX-native model: a ridge
least-squares fit of the affine map ``y_{t+d_t} = W y_t + w0`` over the
*whole flattened state*.

Why it earns its keep here rather than in scikit-learn: the reference's
per-mesh-point input layout (supervised_ml_operator.py:359-379 — every
row carries the full flattened state plus one point's coordinates, and
predicts that point's value) makes a shared per-row linear model rank-1
in the state; a DeepONet's trunk breaks that symmetry but bounds the
map's rank by its feature width. This regressor instead reconstructs
the state pairs from the layout and fits the full-rank operator in one
normal-equations solve — for linear PDEs (diffusion et al.) the true
slice-jump map IS affine, so the fit is exact up to data conditioning,
and inference is a single ``(state, state)`` matvec.
Composed as a Parareal coarse operator, the affine map is consumed
directly by the log-depth doubling-scan machinery
(:mod:`pararealml_tpu.ops.linear_propagator`), keeping the entire
coarse sweep on the matmul path.

The model is time-invariant by construction: any time/step-size feature
column in the layout is ignored, matching the auto-regressive
``SupervisedMLOperator`` mode whose step map does not depend on t.

:class:`ReducedQuadraticStateOperatorRegressor` extends the same
closed-form recipe to NONLINEAR slice jumps (Burgers, Van der Pol, any
PDE whose flow map is not affine): it keeps the full-rank linear term
``A y`` and adds a quadratic term evaluated in a POD-reduced subspace
of the training states, ``B q((y - mean) V)``, so the feature count
stays ``O(state + rank^2)`` instead of ``O(state^2)`` and both fit and
inference remain dense matmuls. This is the second-order
Taylor expansion of the flow map around the training manifold, learned
by ridge regression instead of derived — exactly the role the
reference assigns to its Keras regressors as Parareal coarse operators
(/root/reference/README.md:9-13), with a model class whose inference
is two small matmuls instead of a network roll-out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np
from sklearn.base import BaseEstimator, RegressorMixin


class StateOperatorRidgeRegressor(RegressorMixin, BaseEstimator):
    """Scikit-learn-protocol ridge regression of the affine state map.

    :param state_size: the flattened solution size (the number of
        leading feature columns carrying the state in the supervised
        input layout)
    :param alpha: the ridge regularization strength, scaled by the
        number of state samples at fit time
    :param dtype: the dtype of the fitted operator used at inference
    """

    # SupervisedMLOperator.fit_model splits over whole state samples
    # instead of individual rows for models carrying this tag, keeping
    # the per-state row blocks this regressor reconstructs contiguous
    requires_state_blocks = True

    def __init__(
        self,
        state_size: int,
        alpha: float = 1e-7,
        dtype=jnp.float32,
    ):
        self.state_size = state_size
        self.alpha = alpha
        self.dtype = dtype
        self._weights: Optional[jnp.ndarray] = None
        self._intercept: Optional[jnp.ndarray] = None

    # -- fitted-operator surface -------------------------------------------

    @property
    def state_map(self) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """The fitted ``(W, w0)`` of ``y' = W y + w0`` over the
        flattened state."""
        if self._weights is None:
            raise ValueError("regressor is not fitted")
        return self._weights, self._intercept

    @state_map.setter
    def state_map(self, value: Tuple[jnp.ndarray, jnp.ndarray]):
        weights, intercept = value
        weights = jnp.asarray(weights, self.dtype)
        intercept = jnp.asarray(intercept, self.dtype)
        if weights.shape != (self.state_size, self.state_size):
            raise ValueError(
                f"weights must be {(self.state_size,) * 2}, got "
                f"{weights.shape}"
            )
        if intercept.shape != (self.state_size,):
            raise ValueError(
                f"intercept must be ({self.state_size},), got "
                f"{intercept.shape}"
            )
        self._weights = weights
        self._intercept = intercept

    # -- layout handling ----------------------------------------------------

    def _to_state_pairs(
        self, x: np.ndarray, y: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Reconstructs ``(states, next_states)`` from the per-point
        supervised layout: rows arrive in blocks that share the same
        flattened state in the first ``state_size`` columns and carry
        one mesh point's target values each."""
        x = np.asarray(x)
        y = np.asarray(y)
        if x.ndim != 2 or x.shape[1] < self.state_size:
            raise ValueError(
                "inputs must be 2D with at least "
                f"{self.state_size} feature columns"
            )
        y = y.reshape(len(x), -1)
        y_dimension = y.shape[1]
        block = self.state_size // y_dimension
        if (
            block * y_dimension != self.state_size
            or len(x) % block != 0
        ):
            raise ValueError(
                "row count is not a whole number of state blocks"
            )
        states = x[::block, : self.state_size]
        next_states = y.reshape(-1, self.state_size)
        return states, next_states

    # -- sklearn protocol ---------------------------------------------------

    def fit(
        self, x: np.ndarray, y: np.ndarray
    ) -> "StateOperatorRidgeRegressor":
        states, next_states = self._to_state_pairs(x, y)
        n_samples = len(states)
        design = np.concatenate(
            [states, np.ones((n_samples, 1))], axis=1
        ).astype(np.float64)
        targets = next_states.astype(np.float64)
        gram = design.T @ design
        gram[np.diag_indices_from(gram)] += self.alpha * n_samples
        solution = np.linalg.solve(gram, design.T @ targets)
        self.state_map = (
            solution[:-1].T,
            solution[-1],
        )
        return self

    def _apply_states(self, states: jnp.ndarray) -> jnp.ndarray:
        """The fitted step map over a ``(samples, state)`` batch."""
        weights, intercept = self.state_map
        return states @ weights.T + intercept

    def _check_fitted(self) -> None:
        if self._weights is None:
            raise ValueError("regressor is not fitted")

    @property
    def jax_step_map(self):
        """A jittable ``y_flat -> next_y_flat`` of the fitted operator
        (the protocol :class:`SupervisedMLOperator` resolves for its
        compiled trajectory/ends functions)."""
        self._check_fitted()

        def step(y_flat: jnp.ndarray) -> jnp.ndarray:
            return self._apply_states(y_flat[jnp.newaxis])[0]

        return step

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Per-row predictions for inputs in the supervised layout
        (each block of rows sharing a state yields that state's
        predicted next values, one mesh point per row)."""
        x = np.asarray(x)
        n_rows = len(x)
        # block size from the layout: every state column block repeats
        # for each of its mesh points; infer the per-state row count
        # from the first repetition boundary
        block = 1
        while block < n_rows and np.array_equal(
            x[block, : self.state_size], x[0, : self.state_size]
        ):
            block += 1
        if n_rows % block != 0:
            raise ValueError(
                "row count is not a whole number of state blocks"
            )
        states = jnp.asarray(
            x[::block, : self.state_size], self.dtype
        )
        predictions = self._apply_states(states)
        return np.asarray(predictions).reshape(n_rows, -1)

    def score(self, x: np.ndarray, y: np.ndarray) -> float:
        y = np.asarray(y).reshape(len(x), -1)
        predictions = self.predict(x)
        residual = float(np.sum((y - predictions) ** 2))
        total = float(np.sum((y - np.mean(y, axis=0)) ** 2))
        return 1.0 - residual / total if total else 1.0

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        from pararealml_tpu.utils.checkpoint import save_pytree

        save_pytree(
            path,
            {"weights": self._weights, "intercept": self._intercept},
        )

    def load(self, path: str) -> None:
        from pararealml_tpu.utils.checkpoint import load_pytree

        template = {
            "weights": jnp.zeros(
                (self.state_size, self.state_size), self.dtype
            ),
            "intercept": jnp.zeros((self.state_size,), self.dtype),
        }
        saved = load_pytree(path, template)
        self.state_map = (saved["weights"], saved["intercept"])


class ReducedQuadraticStateOperatorRegressor(
    StateOperatorRidgeRegressor
):
    """Closed-form ridge fit of a quadratic state-transition map.

    Models the slice jump as

    ``y' = A y + B q(z) + c,   z = (y - mean) V``

    where ``V`` is the ``(state, rank)`` POD basis of the centered
    training states (top right-singular vectors) and ``q(z)`` stacks
    the ``rank (rank + 1) / 2`` upper-triangular entries of ``z z^T``.
    The linear term keeps the affine regressor's full-rank coverage of
    linear dynamics; the quadratic term is the flow map's second-order
    Taylor correction restricted to the subspace the training data
    actually explores, so the feature count is ``state + rank^2 / 2``
    instead of the intractable full ``state^2``. Everything is fitted
    in one float64 normal-equations solve and applied as two dense
    matmuls — the same matmul-friendly shape as the affine fit, now valid
    for nonlinear problems (Burgers et al.) where the reference reaches
    for trained Keras surrogates
    (/root/reference/pararealml/operators/ml/supervised/
    sklearn_keras_regressor.py:13-214).

    :param state_size: the flattened solution size
    :param rank: the POD subspace dimension carrying quadratic terms
    :param alpha: ridge strength, scaled by the sample count at fit
        time
    :param dtype: the dtype of the fitted operator used at inference
    :param trust_margin: how far past the training data's per-mode
        coefficient range the quadratic term keeps extrapolating before
        its inputs are clamped (1.0 = exactly the training range).
        Quadratic extrapolation is unbounded — one out-of-manifold
        state (e.g. an early Parareal iterate on a not-yet-converged
        border) would otherwise be amplified every sweep and diverge —
        so outside the trust region the map smoothly degrades to
        affine-plus-frozen-quadratic, which is Lipschitz and safe to
        iterate.
    """

    def __init__(
        self,
        state_size: int,
        rank: int = 24,
        alpha: float = 1e-9,
        dtype=jnp.float32,
        trust_margin: float = 1.5,
    ):
        super().__init__(state_size, alpha, dtype)
        self.rank = rank
        self.trust_margin = trust_margin
        self._quad_weights: Optional[jnp.ndarray] = None
        self._quad_weights_full: Optional[jnp.ndarray] = None
        self._basis: Optional[jnp.ndarray] = None
        self._mean: Optional[jnp.ndarray] = None
        self._z_low: Optional[jnp.ndarray] = None
        self._z_high: Optional[jnp.ndarray] = None
        self._weight_factors = None
        self._quad_factors = None

    def _check_fitted(self) -> None:
        if self._quad_weights is None:
            raise ValueError("regressor is not fitted")

    @property
    def _triu_indices(self) -> Tuple[np.ndarray, np.ndarray]:
        return np.triu_indices(self.rank)

    def _quadratic_features(self, z: np.ndarray) -> np.ndarray:
        rows, cols = self._triu_indices
        return z[:, rows] * z[:, cols]

    def _expand_quad_weights(self) -> None:
        """Expands the fitted upper-triangular quadratic weights to the
        full ``(state, rank, rank)`` outer-product form used at
        inference: ``q_triu(z) @ B.T == vec(z z^T) @ B_full.T`` with
        off-diagonal weights split evenly between the two symmetric
        outer entries. The triangular form stays the persisted/fitted
        representation; the full form exists because evaluating
        ``z[:, rows] * z[:, cols]`` is a gather (528 elements at rank
        32) on the serial Parareal coarse sweep, while
        ``outer(z, z).reshape(-1)`` is one broadcast multiply."""
        rows, cols = self._triu_indices
        weights = np.asarray(self._quad_weights, np.float64)
        full = np.zeros(
            (self.state_size, self.rank, self.rank), np.float64
        )
        off_diagonal = (rows != cols).astype(np.float64)
        split = weights * (1.0 - 0.5 * off_diagonal)
        full[:, rows, cols] = split
        full[:, cols, rows] = split
        self._quad_weights_full = jnp.asarray(
            full.reshape(self.state_size, self.rank * self.rank),
            self.dtype,
        )

    def fit(
        self, x: np.ndarray, y: np.ndarray
    ) -> "ReducedQuadraticStateOperatorRegressor":
        states, next_states = self._to_state_pairs(x, y)
        states = states.astype(np.float64)
        targets = next_states.astype(np.float64)
        n_samples = len(states)

        mean = states.mean(axis=0)
        centered = states - mean
        # POD basis of the training manifold: the quadratic features
        # live where the data actually varies. The top right-singular
        # vectors come from the symmetric eigenproblem of the state
        # Gram matrix — one (state, state) eigh instead of an SVD of
        # the full (samples, state) data (LAPACK's divide-and-conquer
        # SVD is also non-convergent on some large ill-conditioned
        # trajectory matrices this path must digest)
        gram_states = centered.T @ centered
        eigenvalues, eigenvectors = np.linalg.eigh(gram_states)
        order = np.argsort(eigenvalues)[::-1]
        spread = int(
            np.sum(eigenvalues > max(eigenvalues.max(), 0.0) * 1e-12)
        )
        if spread < self.rank:
            raise ValueError(
                f"rank ({self.rank}) exceeds the training sample "
                f"spread ({spread} modes); provide more data or "
                "lower the rank"
            )
        basis = eigenvectors[:, order[: self.rank]]

        z = centered @ basis
        design = np.concatenate(
            [
                states,
                self._quadratic_features(z),
                np.ones((n_samples, 1)),
            ],
            axis=1,
        )
        gram = design.T @ design
        gram[np.diag_indices_from(gram)] += self.alpha * n_samples
        solution = np.linalg.solve(gram, design.T @ targets)

        n = self.state_size
        n_quad = len(self._triu_indices[0])
        self._weights = jnp.asarray(solution[:n].T, self.dtype)
        self._quad_weights = jnp.asarray(
            solution[n : n + n_quad].T, self.dtype
        )
        self._intercept = jnp.asarray(solution[-1], self.dtype)
        self._basis = jnp.asarray(basis, self.dtype)
        self._mean = jnp.asarray(mean, self.dtype)
        # trust region: the per-mode coefficient range the quadratic
        # term was fitted over, stretched by the margin around each
        # mode's midpoint
        z_min, z_max = z.min(axis=0), z.max(axis=0)
        z_mid = 0.5 * (z_min + z_max)
        z_half = 0.5 * (z_max - z_min) * self.trust_margin
        self._z_low = jnp.asarray(z_mid - z_half, self.dtype)
        self._z_high = jnp.asarray(z_mid + z_half, self.dtype)
        self._expand_quad_weights()
        self._factor_operators()
        return self

    @staticmethod
    def _truncated_factors(matrix, dtype, max_rel_error):
        """Low-rank SVD factors of an operator matrix, or ``None`` when
        truncation at the tolerance saves nothing. Applying the fitted
        map to ONE state (a Parareal coarse sweep is n dependent
        single-state applies) reads the whole ``(k, m)`` matrix per
        apply, so splitting ``W`` into ``(k, r) @ (r, m)`` factors cuts
        the bytes read — and the serial sweep's wall time — by
        ``~min(k, m) / (2 r)``. The
        truncation tail is bounded by ``max_rel_error * sigma_0``,
        placed well under float32 matmul noise by default."""
        m64 = np.asarray(matrix, np.float64)
        u, sigma, vt = np.linalg.svd(m64, full_matrices=False)
        if sigma[0] == 0.0:
            return None
        r = max(1, int(np.sum(sigma > sigma[0] * max_rel_error)))
        n_out, n_in = m64.shape
        if r * (n_out + n_in) >= n_out * n_in:
            return None
        right = vt[:r].T  # (n_in, r)
        left = u[:, :r] * sigma[:r]  # (n_out, r)
        return (
            jnp.asarray(right, dtype),
            jnp.asarray(left, dtype),
        )

    def _factor_operators(self, max_rel_error: float = 1e-6) -> None:
        self._weight_factors = self._truncated_factors(
            self._weights, self.dtype, max_rel_error
        )
        self._quad_factors = self._truncated_factors(
            self._quad_weights_full, self.dtype, max_rel_error
        )

    def _apply_states(self, states: jnp.ndarray) -> jnp.ndarray:
        self._check_fitted()
        dtype = states.dtype
        z = (states - self._mean.astype(dtype)) @ self._basis.astype(
            dtype
        )
        z = jnp.clip(
            z, self._z_low.astype(dtype), self._z_high.astype(dtype)
        )
        # gather-free quadratic features: the full outer product
        # (see _expand_quad_weights)
        quad = (z[..., :, jnp.newaxis] * z[..., jnp.newaxis, :]).reshape(
            *z.shape[:-1], self.rank * self.rank
        )
        if self._weight_factors is not None:
            right, left = self._weight_factors
            linear = (states @ right.astype(dtype)) @ left.astype(
                dtype
            ).T
        else:
            linear = states @ self._weights.astype(dtype).T
        if self._quad_factors is not None:
            q_right, q_left = self._quad_factors
            quadratic = (quad @ q_right.astype(dtype)) @ q_left.astype(
                dtype
            ).T
        else:
            quadratic = quad @ self._quad_weights_full.astype(dtype).T
        return linear + quadratic + self._intercept.astype(dtype)

    def save(self, path: str) -> None:
        from pararealml_tpu.utils.checkpoint import save_pytree

        self._check_fitted()
        save_pytree(
            path,
            {
                "weights": self._weights,
                "quad_weights": self._quad_weights,
                "intercept": self._intercept,
                "basis": self._basis,
                "mean": self._mean,
                "z_low": self._z_low,
                "z_high": self._z_high,
            },
        )

    def load(self, path: str) -> None:
        from pararealml_tpu.utils.checkpoint import load_pytree

        n = self.state_size
        n_quad = len(self._triu_indices[0])
        template = {
            "weights": jnp.zeros((n, n), self.dtype),
            "quad_weights": jnp.zeros((n, n_quad), self.dtype),
            "intercept": jnp.zeros((n,), self.dtype),
            "basis": jnp.zeros((n, self.rank), self.dtype),
            "mean": jnp.zeros((n,), self.dtype),
            "z_low": jnp.zeros((self.rank,), self.dtype),
            "z_high": jnp.zeros((self.rank,), self.dtype),
        }
        saved = load_pytree(path, template)
        self._weights = saved["weights"]
        self._quad_weights = saved["quad_weights"]
        self._intercept = saved["intercept"]
        self._basis = saved["basis"]
        self._mean = saved["mean"]
        self._z_low = saved["z_low"]
        self._z_high = saved["z_high"]
        self._expand_quad_weights()
        self._factor_operators()
