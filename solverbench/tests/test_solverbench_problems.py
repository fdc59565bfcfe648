"""Each frozen generator gives the port's arrays, array for array, at a
small size."""
import numpy as np
import pytest

from solverbench.problems import fe_p1_square, poisson_2d


def _same(frozen, port):
    for k in ("indptr", "indices", "data"):
        a, b = getattr(frozen, k), getattr(port, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_poisson_2d_is_the_ports():
    from faspsolver_tpu_torch.testgen import poisson_2d as port
    P = poisson_2d.build(31)
    A = port(31)
    _same(P, A)
    assert np.array_equal(P.rhs, A.matvec(np.ones(A.nrow)))   # bench.py's b
    h = 1 / 32
    assert np.array_equal(P.coords[:2], [[h, h], [2 * h, h]])


def test_fe_p1_square_is_the_ports():
    from faspsolver_tpu_torch.testgen import assemble_poisson, unit_square_mesh
    P = fe_p1_square.build(32)
    mesh = unit_square_mesh(32)
    A, b, interior = assemble_poisson(mesh, lambda p: np.ones(len(p)))
    _same(P, A)
    assert np.array_equal(P.rhs, b)
    assert np.array_equal(P.coords, mesh.nodes[interior])


@pytest.mark.parametrize("gen,arg", [(poisson_2d, 31), (fe_p1_square, 32)])
def test_both_number_the_unknowns_alike(gen, arg):
    """Row j * 31 + i of either matrix sits at ((i + 1) h, (j + 1) h)."""
    c = gen.build(arg).coords
    g = np.arange(1, 32) / 32
    X, Y = np.meshgrid(g, g)
    assert np.allclose(c, np.stack([X.ravel(), Y.ravel()], axis=1))
