"""Bayesian neural network demo: uncertainty quantification + active learning.

Mirrors the reference's examples/bayesian_nn_demo.py capability (sparse-data
regression with credible intervals, then active-learning selection) on the
JAX engine: the BNN trains by true ELBO variational inference (jitted
value_and_grad + optax, learned mu AND sigma — cf. reference tsu/ml.py:358-456
whose sigma merely decayed), and MC prediction vmaps over weight samples.

Run: python examples/bayesian_nn_demo.py  (GPU if available; CPU works)
"""

import numpy as np

from tsu_tpu import BayesianRegressor


def main():
    rng = np.random.default_rng(42)

    # Sparse training data: 7 points of a noisy sinusoid.
    x_train = np.array([-3.0, -2.0, -1.0, 0.0, 1.0, 2.0, 3.0]).reshape(-1, 1)
    y_train = np.sin(x_train) + 0.1 * rng.standard_normal((7, 1))

    print("[1] Training a BayesianRegressor on 7 points (SVI, true ELBO)")
    model = BayesianRegressor(input_dim=1, hidden_dims=[20, 20],
                              prior_std=1.0, temperature=1.0, seed=0)
    history = model.fit(x_train, y_train, n_epochs=300, learning_rate=0.01,
                        kl_weight=0.01)
    print(f"    final loss {history['loss_history'][-1]:.4f}")

    # Predict with credible intervals on a dense grid.
    x_test = np.linspace(-5, 5, 101).reshape(-1, 1)
    mean, lower, upper = model.predict_with_interval(
        x_test, n_samples=200, confidence=0.95
    )

    in_range = (np.abs(x_test) <= 3).ravel()
    width_in = float(np.mean(upper[in_range] - lower[in_range]))
    width_out = float(np.mean(upper[~in_range] - lower[~in_range]))
    print("[2] 95% credible-interval width: "
          f"{width_in:.3f} inside the data, {width_out:.3f} outside "
          f"({width_out / width_in:.1f}x wider where the model is ignorant)")

    # Active learning: ask the model where labels would help most.
    pool = np.linspace(-5, 5, 201).reshape(-1, 1)
    picks = model.select_informative_samples(pool, n_select=5, n_samples=100)
    print("[3] Active-learning picks (highest predictive std):",
          np.round(pool[picks].ravel(), 2))

    # Optional plot (saved, not shown).
    try:
        import matplotlib

        matplotlib.use("Agg")
        from tsu_tpu.visualization import plot_predictions_with_uncertainty

        fig = plot_predictions_with_uncertainty(
            x_test.ravel(), mean.ravel(),
            (upper - lower).ravel() / 4.0,  # ~1 std
            x_train=x_train.ravel(), y_train=y_train.ravel(),
        )
        fig.savefig("visual_output/bayesian_nn_demo.png", dpi=120)
        print("[4] Saved visual_output/bayesian_nn_demo.png")
    except Exception as exc:  # noqa: BLE001 — plotting is optional
        print(f"[4] Plot skipped: {exc}")


if __name__ == "__main__":
    main()
