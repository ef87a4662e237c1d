"""The byte counter behind ``step_roofline``: one figure a face, whatever
route implements it, equal to a count by hand."""

import inspect

import pytest

from gpbench.reference import roofline


def test_stacked_count_by_hand():
    # G=4, W=2, K=1, R=3, N=1: a replica's state is 12 + 7*2 = 26 words,
    # read and written (52), 1 request word, an out row of 6 + 3*2 = 12
    # words: 65 words = 260 B and the want byte, a replica-group; the 3 x 3
    # heard bytes once
    assert roofline.stacked_bytes(4, 2, 1, 3, 1) == 3 * 4 * 261 + 9
    # N=2 substeps: the state once, two request tiles and two out rows
    assert roofline.stacked_bytes(4, 2, 1, 3, 2) == 3 * 4 * (4 * (52 + 2 + 24) + 1) + 9


def test_packed_count_by_hand():
    # state 52, gathered 3 x (4 + 4*2) = 36, 1 request word, out 12, blob
    # 12, heat read and written 2: 115 words = 460 B and the want byte a
    # group; 3 heard bytes
    assert roofline.packed_bytes(4, 2, 1, 3, 1, heat=True) == 4 * 461 + 3
    assert roofline.packed_bytes(4, 2, 1, 3, 1, heat=False) == 4 * 453 + 3


@pytest.mark.parametrize("R, N", [(3, 1), (3, 8), (9, 8), (3, 2)])
def test_stacked_count_ignores_the_route(R, N):
    """The port runs N=1 as ``gp_make_blob`` and ``gp_step`` through a
    blob matrix in device memory, N > 1 with R <= 8 as one
    ``gp_step_cluster`` launch, and N > 1 with more replicas as N
    launches: the count is the face's work, the same for every route."""
    from gigapaxos_tpu_torch.ops import gp_kernels
    from gigapaxos_tpu_torch.ops.engine import EngineConfig

    G, W, K = 2_097_152, 32, 16
    route = gp_kernels.stacked_route(EngineConfig(G, W, K, R), N)
    assert route == ("cluster" if N > 1 and R <= 8 else "launches")
    assert "route" not in inspect.signature(roofline.face_bytes).parameters
    per_group = 4 * (2 * (12 + 7 * W) + N * K + N * (6 + 3 * W)) + 1
    assert roofline.face_bytes("stacked", G, W, K, R, N) == R * G * per_group + R * R


def test_blob_exchange_is_not_counted():
    """The route the port takes at N=1 writes and reads an [R, NB] blob
    matrix; the face's count leaves it out, as the cluster route has none."""
    G, W, K, R = 1024, 16, 8, 3
    blob_matrix = R * G * 4 * (4 + 4 * W)
    with_matrix = roofline.stacked_bytes(G, W, K, R) + 2 * blob_matrix
    assert roofline.face_bytes("stacked", G, W, K, R) == with_matrix - 2 * blob_matrix


def test_peaks():
    assert roofline.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.peak_bytes_per_s("NVIDIA H100 PCIe") == 2.0e12
    with pytest.raises(ValueError):
        roofline.peak_bytes_per_s("cpu")
