"""Shared example bootstrap: headless plotting and in-repo imports.

Setting ``PRML_SMOKE=1`` activates smoke mode, which monkeypatches the
library's expensive knobs (time horizon, training epochs, data-set
size) so the test suite can execute every example script end-to-end in
seconds while the scripts themselves stay byte-identical to their
full-scale configurations, which match upstream PararealML's examples.
"""
import importlib.util
import os
import sys

if importlib.util.find_spec("matplotlib") is not None:
    import matplotlib

    matplotlib.use("Agg")
sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

SMOKE = os.environ.get("PRML_SMOKE") == "1"
_SMOKE_MAX_ESTIMATORS = 4


def _activate_smoke_mode():
    """Shrinks every expensive knob the examples reach through the
    public API:

    - initial value problems cover ``1/PRML_SMOKE_T_SCALE`` (default a
      tenth) of their time interval, keeping every solver configuration
      (step sizes, slice counts) valid while cutting step counts 10x;
    - physics-informed training runs two epochs;
    - supervised-ML data generation solves two perturbed IVPs;
    - ``SKLearnJaxRegressor`` model fits run two epochs;
    - scikit-learn ensembles fitted by ``SupervisedMLOperator`` keep at
      most ``_SMOKE_MAX_ESTIMATORS`` estimators;
    - animated plots render ``PRML_SMOKE_FRAMES`` (default two) frames
      (full-scale GIFs take minutes per plot under the Pillow writer).
    """
    import pararealml_tpu as prml
    from pararealml_tpu.plot import AnimatedPlot
    from pararealml_tpu.operators.ml.physics_informed import (
        PhysicsInformedMLOperator,
    )
    from pararealml_tpu.operators.ml.supervised import (
        SKLearnJaxRegressor,
        SupervisedMLOperator,
    )

    t_scale = float(os.environ.get("PRML_SMOKE_T_SCALE", "10"))
    max_epochs = int(os.environ.get("PRML_SMOKE_EPOCHS", "2"))
    max_data_iterations = int(
        os.environ.get("PRML_SMOKE_DATA_ITERATIONS", "2")
    )
    max_frames = int(os.environ.get("PRML_SMOKE_FRAMES", "2"))

    animated_init = AnimatedPlot.__init__

    def smoke_animated_init(
        self, figure, n_time_steps, n_frames, interval
    ):
        animated_init(
            self, figure, n_time_steps, min(n_frames, max_frames),
            interval,
        )

    AnimatedPlot.__init__ = smoke_animated_init  # type: ignore

    ivp_init = prml.InitialValueProblem.__init__

    def smoke_ivp_init(self, cp, t_interval, *args, **kwargs):
        # only shrink problems the example script itself constructs;
        # the library builds internal sub-problems (e.g. Parareal's
        # per-slice IVPs) whose intervals must stay exactly as computed
        caller = sys._getframe(1).f_globals.get("__name__", "")
        if not caller.startswith("pararealml_tpu"):
            t_0, t_1 = t_interval
            t_interval = (t_0, t_0 + (t_1 - t_0) / t_scale)
        ivp_init(self, cp, t_interval, *args, **kwargs)

    prml.InitialValueProblem.__init__ = smoke_ivp_init  # type: ignore

    # an SML operator's d_t is the slice-jump length its surrogate
    # learns; scale it with the horizon so slice counts (and Parareal
    # slice divisibility) are preserved
    sml_init = SupervisedMLOperator.__init__

    def smoke_sml_init(self, d_t, *args, **kwargs):
        sml_init(self, d_t / t_scale, *args, **kwargs)

    SupervisedMLOperator.__init__ = smoke_sml_init  # type: ignore

    piml_train = PhysicsInformedMLOperator.train

    def smoke_piml_train(
        self, cp, t_interval, training_data_args, optimization_args,
        *args, **kwargs
    ):
        optimization_args = optimization_args._replace(
            epochs=min(max_epochs, optimization_args.epochs)
        )
        return piml_train(
            self, cp, t_interval, training_data_args,
            optimization_args, *args, **kwargs
        )

    PhysicsInformedMLOperator.train = smoke_piml_train  # type: ignore

    sml_generate = SupervisedMLOperator.generate_data

    def smoke_sml_generate(self, ivp, oracle, iterations, *a, **kw):
        return sml_generate(
            self, ivp, oracle, min(max_data_iterations, iterations),
            *a, **kw
        )

    SupervisedMLOperator.generate_data = smoke_sml_generate  # type: ignore

    sml_train = SupervisedMLOperator.train

    def smoke_sml_train(self, ivp, oracle, model, iterations, *a, **kw):
        return sml_train(
            self, ivp, oracle, model,
            min(max_data_iterations, iterations), *a, **kw
        )

    SupervisedMLOperator.train = smoke_sml_train  # type: ignore

    sml_fit = SupervisedMLOperator.fit_model

    def smoke_sml_fit(self, model, data, *a, **kw):
        if hasattr(model, "n_estimators"):
            model.set_params(
                n_estimators=min(_SMOKE_MAX_ESTIMATORS, model.n_estimators)
            )
        return sml_fit(self, model, data, *a, **kw)

    SupervisedMLOperator.fit_model = smoke_sml_fit  # type: ignore

    regressor_init = SKLearnJaxRegressor.__init__

    def smoke_regressor_init(self, build_fn, *args, **kwargs):
        kwargs["epochs"] = min(
            max_epochs, kwargs.get("epochs", max_epochs)
        )
        regressor_init(self, build_fn, *args, **kwargs)

    SKLearnJaxRegressor.__init__ = smoke_regressor_init  # type: ignore


if SMOKE:
    _activate_smoke_mode()
