"""``paddle_tpu_torch.linalg`` against ``paddle_tpu.linalg`` on the CPU:
every function on the same seeded numpy inputs through both packages.

Bounds are the reference's own (``tests/test_linalg.py``): rtol 1e-4,
atol 1e-4 for values, 1e-3 for a reconstruction. Outputs unique only up
to a sign or phase (``qr``, ``svd``, ``eig``, ``eigh``,
``householder_product``, ``svd_lowrank``'s factors) are compared after
sign normalisation (each column's largest entry made positive) or by
their invariants (``Q R = A``, ``A v = λ v``), never by a looser bound.
Integer outputs (ranks, pivots, infos) are equal."""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as TP
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

TOL = dict(rtol=1e-4, atol=1e-4)
REC = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(autouse=True)
def cpu():
    prev = tplace._current_place[0]
    TP.set_device("cpu")
    yield
    tplace._current_place[0] = prev


def _np(t):
    v = t._value if hasattr(t, "_value") else t
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _both(name, *arrays, **kw):
    """``linalg.<name>`` on the same arrays in both packages: (ref, port),
    each a numpy array or a tuple of them."""
    out = []
    for pkg in (J, TP):
        r = getattr(pkg.linalg, name)(*[pkg.to_tensor(a) for a in arrays],
                                      **kw)
        out.append(tuple(_np(x) for x in r) if isinstance(r, (tuple, list))
                   else _np(r))
    return out


R = np.random.RandomState(0)
A = R.randn(5, 5).astype(np.float32)
SPD = (A @ A.T + 5 * np.eye(5)).astype(np.float32)
B = R.randn(5, 3).astype(np.float32)
WIDE = R.randn(3, 6).astype(np.float32)
TALL = R.randn(7, 4).astype(np.float32)
BATCH = R.randn(2, 4, 4).astype(np.float32) + 4 * np.eye(4, dtype=np.float32)

VALUE_CASES = {
    "inv": (("inv", A), {}),
    "inv_batch": (("inv", BATCH), {}),
    "pinv": (("pinv", TALL), {}),
    "det": (("det", A), {}),
    "slogdet": (("slogdet", A), {}),
    "cholesky": (("cholesky", SPD), {}),
    "cholesky_upper": (("cholesky", SPD), {"upper": True}),
    "cond": (("cond", A), {}),
    "cond_fro": (("cond", A), {"p": "fro"}),
    "eigvalsh": (("eigvalsh", A), {}),
    "eigvalsh_U": (("eigvalsh", A), {"UPLO": "U"}),
    "solve": (("solve", SPD, B), {}),
    "solve_vec": (("solve", SPD, B[:, 0]), {}),
    "solve_batch": (("solve", BATCH, R.randn(2, 4, 3).astype(np.float32)),
                    {}),
    "triangular_solve": (("triangular_solve", np.triu(SPD), B), {}),
    "triangular_solve_lower_t": (("triangular_solve", np.tril(SPD), B),
                                 {"upper": False, "transpose": True}),
    "triangular_solve_unit": (("triangular_solve", np.triu(SPD), B),
                              {"unitriangular": True}),
    "lstsq": (("lstsq", TALL, R.randn(7, 2).astype(np.float32)), {}),
    "lstsq_vec": (("lstsq", TALL, R.randn(7).astype(np.float32)), {}),
    "matrix_power": (("matrix_power", A), {"n": 3}),
    "matrix_power_neg": (("matrix_power", SPD), {"n": -2}),
    "cholesky_solve": (("cholesky_solve", B, np.linalg.cholesky(SPD)
                        .astype(np.float32)), {}),
    "cholesky_solve_upper": (("cholesky_solve", B, np.linalg.cholesky(SPD)
                              .T.copy().astype(np.float32)),
                             {"upper": True}),
    "cov": (("cov", WIDE), {}),
    "cov_cols": (("cov", TALL), {"rowvar": False, "ddof": False}),
    "corrcoef": (("corrcoef", WIDE), {}),
    "corrcoef_cols": (("corrcoef", TALL), {"rowvar": False}),
    "vector_norm": (("vector_norm", TALL), {}),
    "vector_norm_inf_axis": (("vector_norm", TALL),
                             {"p": float("inf"), "axis": 1,
                              "keepdim": True}),
    "vector_norm_1": (("vector_norm", TALL), {"p": 1.0, "axis": 0}),
    "matrix_norm": (("matrix_norm", TALL), {}),
    "matrix_norm_nuc": (("matrix_norm", TALL), {"p": "nuc"}),
    "matrix_norm_1_keep": (("matrix_norm", BATCH),
                           {"p": 1, "axis": (0, 2), "keepdim": True}),
    "norm": (("norm", TALL), {}),
    "norm_axis": (("norm", TALL), {"p": 1, "axis": 1}),
    "matmul_t": (("matmul", TALL, TALL), {"transpose_x": True}),
}


@pytest.mark.parametrize("case", sorted(VALUE_CASES))
def test_values_match_the_reference(case):
    (name, *arrays), kw = VALUE_CASES[case]
    ref, got = _both(name, *arrays, **kw)
    if isinstance(ref, tuple):
        assert len(got) == len(ref)
        for r, g in zip(ref, got):
            assert g.shape == r.shape
            np.testing.assert_allclose(g, r, **TOL)
    else:
        assert got.shape == ref.shape, (got.shape, ref.shape)
        np.testing.assert_allclose(got, ref, **TOL)


def test_lstsq_rank_and_singular_values():
    sing = TALL.copy()
    sing[:, 3] = sing[:, 0]                     # rank 3
    b = R.randn(7, 2).astype(np.float32)
    for a in (TALL, sing):
        ref, got = _both("lstsq", a, b)
        assert int(got[2]) == int(ref[2])
        assert got[2].dtype == np.int32
        for i in (0, 1, 3):
            np.testing.assert_allclose(got[i], ref[i], **TOL)


def test_multi_dot_and_matrix_rank():
    xs = [R.randn(3, 4).astype(np.float32), R.randn(4, 5).astype(np.float32),
          R.randn(5, 2).astype(np.float32)]
    ref = _np(J.linalg.multi_dot([J.to_tensor(x) for x in xs]))
    got = _np(TP.linalg.multi_dot([TP.to_tensor(x) for x in xs]))
    np.testing.assert_allclose(got, ref, **TOL)
    d = np.diag([100.0, 1.0, 1e-4]).astype(np.float32)
    for kw in ({}, {"tol": 1e-3}, {"hermitian": True}):
        ref, got = _both("matrix_rank", d, **kw)
        assert int(got) == int(ref), kw
    ref, got = _both("matrix_rank", BATCH)
    np.testing.assert_array_equal(got, ref)


def test_lu_pivots_infos_and_unpack():
    sing = A.copy()
    sing[2] = 0.0                               # a zero pivot: info > 0
    for a in (A, SPD, sing, BATCH):
        ref, got = _both("lu", a, get_infos=True)
        np.testing.assert_allclose(got[0], ref[0], **TOL)
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[1].dtype == np.int32
        np.testing.assert_array_equal(got[2], ref[2])
        rp = [J.to_tensor(x) for x in ref[:2]]
        tp = [TP.to_tensor(x) for x in ref[:2]]
        P, L, U = (_np(x) for x in J.linalg.lu_unpack(*rp))
        p, l, u = (_np(x) for x in TP.linalg.lu_unpack(*tp))
        for w, g in ((P, p), (L, l), (U, u)):
            np.testing.assert_allclose(g, w, **TOL)
        np.testing.assert_allclose(p @ l @ u, a, **REC)


def _signs(m):
    """Columns scaled by the sign of their largest-magnitude entry."""
    idx = np.argmax(np.abs(m), axis=-2)
    s = np.sign(np.take_along_axis(m, idx[..., None, :], axis=-2))
    return m * np.where(s == 0, 1, s)


@pytest.mark.parametrize("mode", ["reduced", "complete", "r"])
@pytest.mark.parametrize("a", [TALL, WIDE, A], ids=["tall", "wide", "square"])
def test_qr_matches_after_sign_normalisation(mode, a):
    ref, got = _both("qr", a, mode=mode)
    if mode == "r":
        assert got.shape == ref.shape
        np.testing.assert_allclose(np.abs(got), np.abs(ref), **TOL)
        return
    (rq, rr), (q, r) = ref, got
    assert q.shape == rq.shape and r.shape == rr.shape
    np.testing.assert_allclose(q @ r, a, **REC)
    k = min(a.shape)
    np.testing.assert_allclose(_signs(q[:, :k]), _signs(rq[:, :k]), **TOL)


@pytest.mark.parametrize("full", [False, True])
def test_svd_matches_after_sign_normalisation(full):
    ref, got = _both("svd", TALL, full_matrices=full)
    (ru, rs, rvh), (u, s, vh) = ref, got
    assert u.shape == ru.shape and vh.shape == rvh.shape
    np.testing.assert_allclose(s, rs, **TOL)
    k = s.shape[0]
    np.testing.assert_allclose(u[:, :k] * s @ vh[:k], TALL, **REC)
    np.testing.assert_allclose(_signs(u[:, :k]), _signs(ru[:, :k]), **TOL)
    np.testing.assert_allclose(_signs(vh[:k].T), _signs(rvh[:k].T), **TOL)


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_eigh_reads_one_triangle(uplo):
    ref, got = _both("eigh", A, UPLO=uplo)
    (rw, rv), (w, v) = ref, got
    np.testing.assert_allclose(w, rw, **TOL)
    np.testing.assert_allclose(_signs(v), _signs(rv), **TOL)
    sym = (np.tril(A) + np.tril(A, -1).T if uplo == "L"
           else np.triu(A) + np.triu(A, 1).T)
    np.testing.assert_allclose(sym @ v, v * w, **REC)


def test_eig_and_eigvals_by_invariants():
    ref, got = _both("eig", A)
    (rw, _), (w, v) = ref, got
    key = lambda z: (np.round(z.real, 4), np.round(z.imag, 4))  # noqa: E731
    np.testing.assert_allclose(sorted(w, key=key), sorted(rw, key=key),
                               **TOL)
    np.testing.assert_allclose(A @ v, v * w, **REC)
    np.testing.assert_allclose(np.linalg.norm(v, axis=0), 1.0, **TOL)
    rv, gv = _both("eigvals", A)
    np.testing.assert_allclose(sorted(gv, key=key), sorted(rv, key=key),
                               **TOL)


def _geqrf(m):
    """Householder QR in geqrf's layout (packed, tau), as the reference's
    test builds it."""
    a = m.astype(np.float64).copy()
    rows, cols = a.shape
    tau = np.zeros(min(rows, cols))
    for i in range(min(rows, cols)):
        x = a[i:, i].copy()
        alpha = -np.sign(x[0] or 1.0) * np.linalg.norm(x)
        v = x.copy()
        v[0] -= alpha
        v = v / v[0]
        tau[i] = 2.0 / (v @ v)
        a[i:, i:] -= np.outer(v * tau[i], v @ a[i:, i:])
        a[i + 1:, i] = v[1:]
    return a.astype(np.float32), tau.astype(np.float32)


@pytest.mark.parametrize("left", [True, False])
@pytest.mark.parametrize("transpose", [False, True])
def test_householder_product_and_ormqr(left, transpose):
    a, tau = _geqrf(R.randn(5, 3).astype(np.float32))
    ref, got = _both("householder_product", a, tau)
    np.testing.assert_allclose(got, ref, **TOL)
    other = R.randn(5, 5).astype(np.float32)
    ref, got = _both("ormqr", a, tau, other, left=left, transpose=transpose)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("centred", [False, True])
def test_svd_lowrank_draws_the_references_sketch(centred):
    """The sketch is ``jax.random.normal(key(0), (n, k))`` drawn by the
    port's key stream: the factors agree after sign normalisation."""
    m = R.randn(8, 6).astype(np.float32)
    extra = (R.randn(8, 6).astype(np.float32) * 0.1,) if centred else ()
    out = []
    for pkg in (J, TP):
        r = pkg.linalg.svd_lowrank(pkg.to_tensor(m), 4, 2,
                                   *(pkg.to_tensor(e) for e in extra))
        out.append([_np(x) for x in r])
    (ru, rs, rv), (u, s, v) = out
    np.testing.assert_allclose(s, rs, **TOL)
    np.testing.assert_allclose(_signs(u), _signs(ru), **REC)
    np.testing.assert_allclose(_signs(v), _signs(rv), **REC)


def test_gradients_flow_through_the_dispatcher():
    x = TP.to_tensor(SPD)
    x.stop_gradient = False
    TP.linalg.det(x).backward()
    xj = J.to_tensor(SPD)
    xj.stop_gradient = False
    J.linalg.det(xj).backward()
    np.testing.assert_allclose(_np(x.grad), _np(xj.grad), rtol=1e-3,
                               atol=1e-3)


def test_ops_are_dispatched_under_the_reference_names():
    from paddle_tpu_torch.observability.runtime import telemetry
    telemetry.reset() if hasattr(telemetry, "reset") else None
    seen = []
    from paddle_tpu_torch.core import dispatch
    real = dispatch._apply_impl

    def spy(fn, args, op_name, static):
        seen.append(op_name)
        return real(fn, args, op_name, static)
    dispatch._apply_impl = spy
    try:
        TP.linalg.inv(TP.to_tensor(A))
        TP.linalg.svd(TP.to_tensor(A))
        TP.linalg.lu(TP.to_tensor(A))
    finally:
        dispatch._apply_impl = real
    assert seen == ["inv", "svd", "lu"]
