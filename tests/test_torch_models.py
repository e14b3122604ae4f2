"""The port's models (``models/``, the model catalog, PREDICT) against the
JAX package's.

The cases of ``tests/integration/test_model.py`` and
``tests/integration/test_incremental_training.py``, run through both
packages' ``Context`` on the same frames, made from a seed with numpy.
Where the same matrix reaches the estimator, its fitted attributes and
the PREDICT column are equal bit for bit; after a device expression
(``x * 2``) within rtol 1e-12.  ``Recorder`` keeps what ``fit`` and
``predict`` receive, so that the matrices themselves (values, dtype,
memory order) and the pandas frames of non-numeric features are compared
too.  An experiment's table is compared without its ``*_time`` columns.
"""
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

from dask_sql_tpu import Context as JaxContext
from dask_sql_tpu.physical.streaming import \
    StreamingUnsupported as JaxStreamingUnsupported
from dask_sql_tpu_torch import Context
from dask_sql_tpu_torch.models.incremental import BatchedPredictor
from dask_sql_tpu_torch.physical.streaming import StreamingUnsupported

sklearn = pytest.importorskip("sklearn")
import sklearn.base  # noqa: E402

CPU = torch.device("cpu")

LOGISTIC = """
    CREATE MODEL my_model WITH (
        model_class = 'sklearn.linear_model.LogisticRegression',
        target_column = 'target'
    ) AS (SELECT x, y, target FROM timeseries)
"""


class Recorder(sklearn.base.BaseEstimator):
    """A model that keeps what it is given: ``fit`` the features and the
    target, ``predict`` the features; it predicts the first feature."""

    def __init__(self, scale=1.0):
        self.scale = scale

    def fit(self, X, y=None):
        self.X_, self.y_ = X, y
        return self

    def partial_fit(self, X, y=None, **kwargs):
        self.batches_ = getattr(self, "batches_", []) + [(X, y, kwargs)]
        return self

    def predict(self, X):
        self.seen_ = X
        first = X.iloc[:, 0] if hasattr(X, "iloc") else X[:, 0]
        return np.asarray(first, dtype=np.float64) * self.scale


class PlainPartial:
    """An estimator that is no sklearn estimator: a running mean of the
    target, fitted batch by batch."""

    def __init__(self):
        self.n_, self.total_ = 0, 0.0

    def partial_fit(self, X, y=None, **kwargs):
        self.n_ += len(y)
        self.total_ += float(np.sum(y))
        return self

    def predict(self, X):
        return np.full(len(X), self.total_ / self.n_)


RECORDER = f"{__name__}.Recorder"
PLAIN = f"{__name__}.PlainPartial"


@pytest.fixture(scope="module")
def training_df():
    rng = np.random.RandomState(42)
    n = 200
    df = pd.DataFrame({"x": rng.uniform(-5, 5, n),
                       "y": rng.uniform(-5, 5, n)})
    df["target"] = (df["x"] * 2 + df["y"] > 0).astype(np.int64)
    df["i"] = rng.randint(-9, 9, n)
    df["label"] = np.where(df["target"] == 1, "up", "down").astype(object)
    df["b"] = rng.rand(n) > 0.5
    df["d"] = pd.to_datetime("2000-01-01") + pd.to_timedelta(
        rng.randint(0, 90, n), unit="D")
    df["s"] = rng.choice(["a", "b"], n).astype(object)
    return df


@pytest.fixture
def contexts(training_df):
    jc, pc = JaxContext(), Context(device=CPU)
    for ctx in (jc, pc):
        ctx.create_table("timeseries", training_df)
    return jc, pc


def _model(ctx, name="my_model"):
    return ctx.schema[ctx.schema_name].models[name]


def _both(contexts, sql):
    return [ctx.sql(sql, return_futures=False) for ctx in contexts]


def _fitted(model) -> dict:
    return {k: np.asarray(v).tolist() for k, v in vars(model).items()
            if k.endswith("_") and not k.startswith("_")}


def test_create_model(contexts):
    jc, pc = contexts
    _both(contexts, LOGISTIC)
    (pm, pcols), (jm, jcols) = _model(pc), _model(jc)
    assert pcols == jcols == ["x", "y"]
    assert _fitted(pm) == _fitted(jm)
    assert pm.classes_.dtype == jm.classes_.dtype


def test_predict(contexts, training_df):
    _both(contexts, LOGISTIC)
    got, want = _both(contexts, "SELECT * FROM PREDICT(MODEL my_model, "
                                "SELECT x, y FROM timeseries)")
    pd.testing.assert_frame_equal(got, want)
    assert len(got) == len(training_df)
    assert (got["target"] == training_df["target"]).mean() > 0.9


def test_show_and_describe_models(contexts):
    _both(contexts, LOGISTIC)
    for sql in ("SHOW MODELS", "DESCRIBE MODEL my_model"):
        got, want = _both(contexts, sql)
        pd.testing.assert_frame_equal(got, want)
    assert "training_columns" in list(got["Params"])


def test_drop_model(contexts):
    jc, pc = contexts
    for ctx in contexts:
        with pytest.raises(RuntimeError, match="no_model is not present"):
            ctx.sql("DROP MODEL no_model")
        ctx.sql("DROP MODEL IF EXISTS no_model")
    _both(contexts, LOGISTIC)
    _both(contexts, "DROP MODEL my_model")
    assert "my_model" not in pc.schema[pc.schema_name].models
    assert "my_model" not in jc.schema[jc.schema_name].models


def test_replace_and_if_not_exists(contexts):
    _both(contexts, LOGISTIC)
    for ctx in contexts:
        with pytest.raises(RuntimeError, match="already present"):
            ctx.sql(LOGISTIC)
    first = _model(contexts[1])[0]
    _both(contexts, LOGISTIC.replace("CREATE MODEL",
                                     "CREATE MODEL IF NOT EXISTS"))
    assert _model(contexts[1])[0] is first
    _both(contexts, LOGISTIC.replace("CREATE MODEL",
                                     "CREATE OR REPLACE MODEL").replace(
        "SELECT x, y", "SELECT x, i, y"))
    (pm, pcols), (jm, jcols) = _model(contexts[1]), _model(contexts[0])
    assert pm is not first and pcols == jcols == ["x", "i", "y"]
    assert _fitted(pm) == _fitted(jm)


def test_create_experiment(contexts):
    got, want = _both(contexts, """
        CREATE EXPERIMENT exp WITH (
            model_class = 'sklearn.linear_model.LogisticRegression',
            experiment_class = 'sklearn.model_selection.GridSearchCV',
            tune_parameters = (C = ARRAY [0.1, 1.0]),
            target_column = 'target'
        ) AS (SELECT x, y, target FROM timeseries)
    """)
    keep = [c for c in want.columns if not c.endswith("_time")]
    assert "mean_test_score" in keep and list(got.columns) == list(
        want.columns)
    pd.testing.assert_frame_equal(got[keep], want[keep])
    assert _fitted(_model(contexts[1], "exp")[0]) == \
        _fitted(_model(contexts[0], "exp")[0])


def test_export_model(contexts, tmp_path):
    _both(contexts, LOGISTIC)
    loaded = []
    for ctx, tag in zip(contexts, "jp"):
        pkl, jbl = tmp_path / f"{tag}.pkl", tmp_path / f"{tag}.joblib"
        ctx.sql(f"EXPORT MODEL my_model WITH (format = 'pickle', "
                f"location = '{pkl}')")
        ctx.sql(f"EXPORT MODEL my_model WITH (format = 'joblib', "
                f"location = '{jbl}')")
        import joblib
        loaded.append((pickle.load(open(pkl, "rb")), joblib.load(jbl)))
        for fmt, exc in (("onnx", NotImplementedError),
                         ("mlflow", NotImplementedError),
                         ("strange", NotImplementedError)):
            with pytest.raises(exc):
                ctx.sql(f"EXPORT MODEL my_model WITH (format = '{fmt}', "
                        "location = 'x')")
        with pytest.raises(AttributeError, match="'location'"):
            ctx.sql("EXPORT MODEL my_model WITH (format = 'pickle')")
        with pytest.raises(RuntimeError, match="is not present"):
            ctx.sql("EXPORT MODEL nope WITH (location = 'x')")
    (jp, jj), (pp, pj) = loaded
    for m in (jj, pp, pj):
        assert _fitted(m) == _fitted(jp)


def test_ml_experiment_requires_class(contexts):
    for ctx in contexts:
        with pytest.raises(AttributeError, match="model_class"):
            ctx.sql("""
                CREATE EXPERIMENT failing WITH (target_column = 'target')
                AS (SELECT x, y, target FROM timeseries)
            """)
        with pytest.raises(AttributeError, match="experiment_class"):
            ctx.sql("""
                CREATE EXPERIMENT failing WITH (target_column = 'target',
                    model_class = 'sklearn.linear_model.LinearRegression')
                AS (SELECT x, y, target FROM timeseries)
            """)
        with pytest.raises(AttributeError, match="model_class"):
            ctx.sql("CREATE MODEL m WITH (target_column = 'target') "
                    "AS (SELECT x, target FROM timeseries)")


def test_predict_on_expression_query(contexts):
    _both(contexts, LOGISTIC.replace("LogisticRegression",
                                     "LinearRegression"))
    got, want = _both(contexts, """
        SELECT AVG(target) AS avg_pred
        FROM PREDICT(MODEL my_model, SELECT x, y FROM timeseries)
    """)
    np.testing.assert_allclose(got["avg_pred"], want["avg_pred"], rtol=1e-12)
    assert 0.0 <= got["avg_pred"][0] <= 1.0
    got, want = _both(contexts, """
        SELECT s, SUM(target) AS t, COUNT(*) AS n FROM PREDICT(MODEL my_model,
            SELECT s, x * 2 AS x, y + 1 AS y FROM timeseries WHERE i > 0)
        GROUP BY s ORDER BY s
    """)
    assert got["s"].tolist() == want["s"].tolist()
    assert got["n"].tolist() == want["n"].tolist()
    np.testing.assert_allclose(got["t"], want["t"], rtol=1e-12)


@pytest.mark.parametrize("compile_", ["0", "1"])
@pytest.mark.parametrize("features", ["x, i, b", "x, d", "x, s"])
def test_the_estimator_receives_what_jax_gives_it(contexts, features,
                                                  compile_, monkeypatch):
    """Numeric features (kinds i, f, b) reach fit and predict as one
    float64 matrix equal to the JAX package's, in the same memory order,
    whether the training query ran eager (the matrix cast on the device)
    or compiled (stacked from the result's host copy); a date or string
    feature as an equal pandas frame; the target as an equal array."""
    monkeypatch.setenv("DSQL_COMPILE", compile_)
    for target in ("target", "label"):
        _both(contexts, f"CREATE OR REPLACE MODEL r WITH (model_class = "
                        f"'{RECORDER}', target_column = '{target}') AS "
                        f"(SELECT {features}, {target} FROM timeseries)")
        pm, jm = _model(contexts[1], "r")[0], _model(contexts[0], "r")[0]
        if isinstance(jm.X_, np.ndarray):
            assert isinstance(pm.X_, np.ndarray)
            np.testing.assert_array_equal(pm.X_, jm.X_, strict=True)
            assert pm.X_.flags.f_contiguous == jm.X_.flags.f_contiguous
        else:
            pd.testing.assert_frame_equal(pm.X_, jm.X_)
        np.testing.assert_array_equal(pm.y_, jm.y_, strict=True)
    if features == "x, i, b":
        got, want = _both(contexts, f"SELECT * FROM PREDICT(MODEL r, "
                                    f"SELECT {features} FROM timeseries)")
        pd.testing.assert_frame_equal(got, want)
        pm, jm = _model(contexts[1], "r")[0], _model(contexts[0], "r")[0]
        np.testing.assert_array_equal(pm.seen_, jm.seen_, strict=True)
        assert pm.seen_.flags.c_contiguous == jm.seen_.flags.c_contiguous


def test_register_model_serves_predict(contexts):
    """A model registered by hand, under a schema, serves PREDICT in both;
    an unknown model fails to bind in both."""
    for ctx in contexts:
        ctx.create_schema("ml")
        ctx.register_model("by_hand", Recorder(2.0), ["y"],
                           schema_name="ml")
    got, want = _both(contexts, "SELECT target FROM PREDICT(MODEL "
                                "ml.by_hand, SELECT y FROM timeseries)")
    pd.testing.assert_frame_equal(got, want)
    for ctx in contexts:
        with pytest.raises(Exception, match="nope"):
            ctx.sql("SELECT * FROM PREDICT(MODEL nope, SELECT y FROM "
                    "timeseries)")


# ---------------------------------------------------------------------------
# incremental training (tests/integration/test_incremental_training.py)
# ---------------------------------------------------------------------------

def _training_frame(n=4000, seed=7):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n)
    x2 = rng.normal(size=n)
    y = (x1 + 0.5 * x2 + rng.normal(scale=0.3, size=n) > 0).astype(np.int64)
    return pd.DataFrame({"x1": x1, "x2": x2, "target": y})


@pytest.fixture(scope="module")
def stream_df():
    return _training_frame()


def _chunked(df, batch_rows, name="timeseries"):
    jc, pc = JaxContext(), Context(device=CPU)
    for ctx in (jc, pc):
        ctx.create_table(name, df, chunked=True, batch_rows=batch_rows)
    return jc, pc


def test_wrap_fit_streams_partial_fit_batches(monkeypatch, stream_df):
    from sklearn.linear_model import SGDClassifier

    calls = {"partial_fit": 0, "fit": 0, "max_rows": 0}
    orig_pf = SGDClassifier.partial_fit

    def counting_pf(self, X, y=None, **kw):
        calls["partial_fit"] += 1
        calls["max_rows"] = max(calls["max_rows"], len(X))
        return orig_pf(self, X, y, **kw)

    def counting_fit(self, *a, **kw):
        calls["fit"] += 1

    monkeypatch.setattr(SGDClassifier, "partial_fit", counting_pf)
    monkeypatch.setattr(SGDClassifier, "fit", counting_fit)
    contexts = _chunked(stream_df, 1000)
    _both(contexts, """
        CREATE MODEL my_model WITH (
            model_class = 'sklearn.linear_model.SGDClassifier',
            wrap_fit = True,
            target_column = 'target',
            loss = 'log_loss',
            random_state = 0
        ) AS SELECT x1, x2, target FROM timeseries
    """)
    assert calls == {"partial_fit": 8, "fit": 0, "max_rows": 1000}
    (pm, pcols), (jm, jcols) = _model(contexts[1]), _model(contexts[0])
    assert pcols == jcols == ["x1", "x2"]
    assert _fitted(pm) == _fitted(jm)
    acc = (pm.predict(stream_df[["x1", "x2"]].to_numpy())
           == stream_df["target"].to_numpy()).mean()
    assert acc > 0.9


def test_wrap_fit_hands_partial_fit_the_same_batches(stream_df):
    contexts = _chunked(stream_df, 1500)
    _both(contexts, f"CREATE MODEL r WITH (model_class = '{RECORDER}', "
                    "wrap_fit = True, target_column = 'target') "
                    "AS SELECT x1, x2, target FROM timeseries")
    pb, jb = (_model(c, "r")[0].batches_ for c in (contexts[1], contexts[0]))
    assert [len(b[0]) for b in pb] == [1500, 1500, 1000]
    for (px, py, pk), (jx, jy, jk) in zip(pb, jb):
        np.testing.assert_array_equal(px, jx, strict=True)
        np.testing.assert_array_equal(py, jy, strict=True)
        assert pk == jk == {}


def test_wrap_fit_classifier_prescans_classes():
    n = 3000
    rng = np.random.default_rng(0)
    df = pd.DataFrame({"x1": rng.normal(size=n),
                       "target": np.repeat([0, 1, 2], n // 3)})
    contexts = _chunked(df, 500, "t")
    _both(contexts, """
        CREATE MODEL m3 WITH (
            model_class = 'sklearn.linear_model.SGDClassifier',
            wrap_fit = True,
            target_column = 'target',
            random_state = 0
        ) AS SELECT x1, target FROM t
    """)
    pm, jm = _model(contexts[1], "m3")[0], _model(contexts[0], "m3")[0]
    assert pm.classes_.tolist() == [0, 1, 2]
    assert _fitted(pm) == _fitted(jm)


def test_wrap_fit_streams_through_projection_and_filter(stream_df):
    contexts = _chunked(stream_df, 512)
    _both(contexts, """
        CREATE MODEL m2 WITH (
            model_class = 'sklearn.linear_model.SGDRegressor',
            wrap_fit = True,
            target_column = 'target',
            random_state = 0
        ) AS SELECT x1 * 2 AS a, x2 + 1 AS b, target
             FROM timeseries WHERE x1 > -10
    """)
    (pm, pcols), (jm, jcols) = (_model(contexts[1], "m2"),
                                _model(contexts[0], "m2"))
    assert pcols == jcols == ["a", "b"]
    np.testing.assert_allclose(pm.coef_, jm.coef_, rtol=1e-12)
    np.testing.assert_allclose(pm.intercept_, jm.intercept_, rtol=1e-12)


def test_wrap_fit_refusals_match(stream_df):
    """An aggregate above the chunked scan is not a row stream, an
    estimator without partial_fit cannot stream, and a plain CREATE MODEL
    over a chunked table is refused by the streaming executor: each
    raises in both packages."""
    contexts = _chunked(stream_df, 1000)
    blocking = """
        CREATE MODEL mbad WITH (
            model_class = 'sklearn.linear_model.SGDClassifier',
            wrap_fit = True,
            target_column = 'target'
        ) AS SELECT x1, MAX(x2) AS x2, MAX(target) AS target
             FROM timeseries GROUP BY x1
    """
    no_partial = """
        CREATE MODEL mbad2 WITH (
            model_class = 'sklearn.tree.DecisionTreeClassifier',
            wrap_fit = True,
            target_column = 'target'
        ) AS SELECT x1, x2, target FROM timeseries
    """
    gathered = """
        CREATE MODEL mg WITH (
            model_class = 'sklearn.linear_model.SGDClassifier',
            target_column = 'target'
        ) AS SELECT x1, x2, target FROM timeseries
    """
    for ctx, unsupported in zip(contexts, (JaxStreamingUnsupported,
                                           StreamingUnsupported)):
        with pytest.raises(unsupported, match="LogicalAggregate"):
            ctx.sql(blocking)
        with pytest.raises(AttributeError, match="partial_fit"):
            ctx.sql(no_partial)
        with pytest.raises(unsupported):
            ctx.sql(gathered)
        assert not ctx.schema[ctx.schema_name].models


def test_wrap_predict_batches_prediction(stream_df):
    contexts = _chunked(stream_df, 1000)
    _both(contexts, """
        CREATE MODEL mp WITH (
            model_class = 'sklearn.linear_model.SGDClassifier',
            wrap_fit = True,
            wrap_predict = True,
            target_column = 'target',
            random_state = 0
        ) AS SELECT x1, x2, target FROM timeseries
    """)
    model = _model(contexts[1], "mp")[0]
    assert isinstance(model, BatchedPredictor)
    X = stream_df[["x1", "x2"]].to_numpy()
    full = np.asarray(model.model.predict(X))
    model.batch_rows = 300
    np.testing.assert_array_equal(full, model.predict(X))
    np.testing.assert_array_equal(model.decision_function(X),
                                  model.model.decision_function(X))
    again = pickle.loads(pickle.dumps(model))
    assert isinstance(again, BatchedPredictor) and again.batch_rows == 300
    np.testing.assert_array_equal(again.predict(X), full)
    assert again.classes_.tolist() == [0, 1]
    for ctx in contexts:
        ctx.create_table("resident", stream_df.head(100))
    got, want = _both(contexts, "SELECT * FROM PREDICT(MODEL mp, "
                                "SELECT x1, x2 FROM resident)")
    pd.testing.assert_frame_equal(got, want)
    assert len(got) == 100


def test_wrap_fit_takes_an_estimator_that_is_not_sklearns(stream_df):
    """An estimator without sklearn's tags streams in the port (its
    ``_estimator_type`` decides the classes prescan); the JAX package's
    ``is_classifier`` raises AttributeError for it under sklearn >= 1.6
    (ROADMAP Queue 3, F20)."""
    jc, pc = _chunked(stream_df, 1000)
    sql = (f"CREATE MODEL pm WITH (model_class = '{PLAIN}', wrap_fit = "
           "True, target_column = 'target') AS SELECT x1, target FROM "
           "timeseries")
    with pytest.raises(AttributeError, match="__sklearn_tags__"):
        jc.sql(sql)
    pc.sql(sql)
    model, cols = _model(pc, "pm")
    assert cols == ["x1"] and model.n_ == len(stream_df)
    assert model.total_ == float(stream_df["target"].sum())


def test_predict_null_features_reach_the_model_as_nan():
    """A NULL in an integer or a float feature reaches ``predict`` as NaN
    in both packages, and the prediction comes back as the JAX
    package's."""
    df = pd.DataFrame({"a": pd.array([1, None, 3, 4], dtype="Int64"),
                       "f": [1.0, None, 2.0, np.nan]})
    seen = []
    for ctx in (JaxContext(), Context(device=CPU)):
        ctx.create_table("t", df)
        model = Recorder(3.0)
        ctx.register_model("m", model, ["a", "f"])
        out = ctx.sql("SELECT * FROM PREDICT(MODEL m, SELECT a, f FROM t)",
                      return_futures=False)
        seen.append((out, model.seen_))
    (jout, jX), (pout, pX) = seen
    pd.testing.assert_frame_equal(pout, jout)
    np.testing.assert_array_equal(pX, jX, strict=True)
    assert np.isnan(pX[1]).all()
