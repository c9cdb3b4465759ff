"""``paddle_tpu_torch.sparse`` and ``paddle_tpu_torch.geometric`` against
the reference's on the CPU, on the same seeded inputs: COO and CSR
densification, ``coalesce`` (its static nnz, sorted coordinates and
``max_nnz`` budget), ``add`` keeping a fixed support's nnz, scaling,
``relu``, ``transpose``, ``to_sparse_coo`` with and without a budget,
``matmul`` and its values' gradient; the message-passing ops
(``send_u_recv`` sum/mean/min/max with empty segments, ``send_ue_recv``,
``send_uv``), the segment ops, ``reindex_graph`` and
``sample_neighbors``, which must make numpy's global generator's draws
exactly as the reference does. Bounds are the reference tests' own
(``test_fft_sparse_dist.py``, ``test_distribution_zoo.py``): rtol 1e-5,
atol 1e-6; coordinates, counts and integer results are equal."""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as TP
from paddle_tpu_torch.core import place as tplace
from paddle_tpu_torch.testing import one_cpu_thread

one_cpu_thread()

TOL = dict(rtol=1e-5, atol=1e-6)


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


def _coo(pkg, idx, vals, shape, **kw):
    return pkg.sparse.sparse_coo_tensor(idx, pkg.to_tensor(vals), shape=shape,
                                        **kw)


R = np.random.RandomState(0)
IDX = np.stack([R.randint(0, 6, 20), R.randint(0, 5, 20)]).astype(np.int32)
VALS = R.randn(20).astype(np.float32)
VALS2 = R.randn(20, 3).astype(np.float32)


@pytest.mark.parametrize("vals", [VALS, VALS2], ids=["scalar", "dense_dim"])
def test_coo_to_dense_coalesce_and_budget(vals):
    shape = (6, 5) + vals.shape[1:]
    out = []
    for pkg in (J, TP):
        st = _coo(pkg, IDX, vals, shape)
        c = st.coalesce()
        cut = st.coalesce(max_nnz=len({tuple(p) for p in IDX.T}))
        out.append([_np(st.to_dense()), _np(c.indices), _np(c.values),
                    c.nnz(), _np(cut.indices), _np(cut.values), cut.nnz()])
    ref, got = out
    for r, g in zip(ref, got):
        if isinstance(r, int):
            assert g == r
        elif r.dtype.kind == "i":
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, **TOL)
    with pytest.raises(ValueError, match="max_nnz"):
        _coo(TP, IDX, vals, shape).coalesce(max_nnz=2)


def test_add_scale_relu_transpose_and_static_nnz():
    out = []
    for pkg in (J, TP):
        g = _coo(pkg, IDX, VALS, (6, 5))
        for _ in range(3):
            g = g + _coo(pkg, IDX, np.ones(20, np.float32), (6, 5))
        other = _coo(pkg, [[5], [4]], np.array([7.0], np.float32), (6, 5))
        s = pkg.sparse.add(g, other) * 2.0
        r = pkg.sparse.relu(s)
        t = s.transpose([1, 0])
        out.append([g.nnz(), s.nnz(), _np(g.to_dense()), _np(s.to_dense()),
                    _np(r.to_dense()), t.shape, _np(t.to_dense())])
    for r, g in zip(*out):
        if isinstance(r, (int, tuple)):
            assert g == r
        else:
            np.testing.assert_allclose(g, r, **TOL)


def test_csr_and_to_sparse_coo():
    dense = np.where(R.rand(5, 6) < 0.4, R.randn(5, 6), 0).astype(np.float32)
    crows = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(
        np.int32)
    cols = np.nonzero(dense)[1].astype(np.int32)
    vals = dense[dense != 0]
    for nnz in (None, 4, 30):
        out = []
        for pkg in (J, TP):
            csr = pkg.sparse.sparse_csr_tensor(crows, cols,
                                               pkg.to_tensor(vals), (5, 6))
            coo = pkg.sparse.to_sparse_coo(pkg.to_tensor(dense), nnz=nnz)
            assert pkg.sparse.is_sparse(csr) and pkg.sparse.is_sparse(coo)
            out.append([_np(csr.to_dense()), _np(coo.indices),
                        _np(coo.values), coo.nnz(), _np(coo.to_dense())])
        for r, g in zip(*out):
            if isinstance(r, int):
                assert g == r
            else:
                np.testing.assert_allclose(g, r, **TOL)


def test_matmul_and_its_gradient():
    rhs = R.randn(5, 4).astype(np.float32)
    out = []
    for pkg in (J, TP):
        st = _coo(pkg, IDX, VALS, (6, 5), stop_gradient=False)
        y = pkg.sparse.matmul(st, pkg.to_tensor(rhs))
        (y * y).sum().backward()
        out.append((_np(y), _np(st.values.grad)))
    (ry, rg), (ty, tg) = out
    np.testing.assert_allclose(ty, ry, **TOL)
    np.testing.assert_allclose(tg, rg, rtol=1e-5, atol=1e-5)


X = R.randn(7, 3).astype(np.float32)
XI = R.randint(-5, 5, (7, 2)).astype(np.int32)
E = R.randn(12, 3).astype(np.float32)
SRC = R.randint(0, 7, 12).astype(np.int32)
DST = np.array([0, 2, 2, 3, 5, 5, 5, 0, 3, 2, 5, 0], np.int32)  # 1, 4 empty


SEND_RECV = [(X, op) for op in ("sum", "mean", "min", "max")] + \
    [(XI, op) for op in ("sum", "min", "max")]       # int32: no mean


@pytest.mark.parametrize("out_size", [None, 9])
@pytest.mark.parametrize("x,reduce_op", SEND_RECV,
                         ids=[f"{x.dtype}-{op}" for x, op in SEND_RECV])
def test_send_u_recv(x, reduce_op, out_size):
    out = [_np(pkg.geometric.send_u_recv(
        pkg.to_tensor(x), pkg.to_tensor(SRC), pkg.to_tensor(DST), reduce_op,
        out_size=out_size)) for pkg in (J, TP)]
    assert out[1].shape == out[0].shape and out[1].dtype == out[0].dtype
    np.testing.assert_allclose(out[1], out[0], **TOL)


@pytest.mark.parametrize("message_op", ["add", "sub", "mul", "div"])
@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max"])
def test_send_ue_recv(message_op, reduce_op):
    out = [_np(pkg.geometric.send_ue_recv(
        pkg.to_tensor(X), pkg.to_tensor(E), pkg.to_tensor(SRC),
        pkg.to_tensor(DST), message_op, reduce_op)) for pkg in (J, TP)]
    np.testing.assert_allclose(out[1], out[0], **TOL)


@pytest.mark.parametrize("message_op", ["add", "sub", "mul", "div"])
def test_send_uv(message_op):
    out = [_np(pkg.geometric.send_uv(
        pkg.to_tensor(X), pkg.to_tensor(X * 2 + 3), pkg.to_tensor(SRC),
        pkg.to_tensor(DST), message_op)) for pkg in (J, TP)]
    np.testing.assert_allclose(out[1], out[0], **TOL)


@pytest.mark.parametrize("op", ["sum", "mean", "min", "max"])
def test_segment_ops(op):
    sid = np.sort(R.randint(0, 4, 7)).astype(np.int32)
    out = [_np(getattr(pkg.geometric, f"segment_{op}")(
        pkg.to_tensor(X), pkg.to_tensor(sid))) for pkg in (J, TP)]
    np.testing.assert_allclose(out[1], out[0], **TOL)


def test_send_u_recv_gradient():
    grads = []
    for pkg in (J, TP):
        x = pkg.to_tensor(X)
        x.stop_gradient = False
        y = pkg.geometric.send_u_recv(x, pkg.to_tensor(SRC),
                                      pkg.to_tensor(DST), "mean")
        (y * y).sum().backward()
        grads.append(_np(x.grad))
    np.testing.assert_allclose(grads[1], grads[0], **TOL)


def test_reindex_graph():
    args = (np.array([10, 20, 5], np.int32),
            np.array([30, 10, 20, 40, 5, 30, 7], np.int32),
            np.array([2, 3, 2], np.int32))
    out = [[_np(t) for t in pkg.geometric.reindex_graph(
        *(pkg.to_tensor(a) for a in args))] for pkg in (J, TP)]
    for r, g in zip(*out):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("sample_size", [-1, 1, 2])
def test_sample_neighbors_draws_numpys_global_stream(sample_size):
    """The reference seeds a RandomState from numpy's global generator;
    the port makes the same draw, so under the same global seed the
    samples are equal."""
    row = R.randint(0, 50, 200).astype(np.int32)
    colptr = np.concatenate([[0], np.sort(R.randint(0, 200, 49)), [200]])
    colptr = colptr.astype(np.int32)
    nodes = np.array([0, 3, 7, 11, 48], np.int32)
    out = []
    for pkg in (J, TP):
        np.random.seed(123)
        nb, cnt = pkg.geometric.sample_neighbors(row, colptr, nodes,
                                                 sample_size=sample_size)
        out.append((_np(nb), _np(cnt), np.random.randint(0, 2 ** 31)))
    (rn, rc, rnext), (tn, tc, tnext) = out
    np.testing.assert_array_equal(tn, rn)
    np.testing.assert_array_equal(tc, rc)
    assert tnext == rnext
    with pytest.raises(NotImplementedError, match="eids"):
        TP.geometric.sample_neighbors(row, colptr, nodes, return_eids=True)
