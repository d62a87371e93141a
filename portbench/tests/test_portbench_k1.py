"""K1's counted work on a hand-sized case, and the reference ICP's
iterations on it."""

import torch

from portbench.entries._slam import k1_work
from portbench.reference import slam as ref

ICP = {"threshold_mm": 180.0, "max_iterations": 50, "tolerance": 0.01, "min_points": 3}


def test_work_of_a_registration_that_starts_converged():
    tgt = torch.tensor([[[0.0, 0.0], [1000.0, 0.0], [0.0, 1000.0], [1000.0, 1000.0], [500.0, 200.0]]],
                       dtype=torch.float64)
    src = tgt[:, :3].clone()
    reg = ref.icp(src, torch.ones(1, 3, dtype=torch.bool), tgt, torch.ones(1, 5, dtype=torch.bool),
                  torch.zeros(1, 3, dtype=torch.float64), ICP, ref.F64)
    # sweep 1 finds err 0 after 1e30 (no convergence), sweep 2 err 0 again: converged
    assert int(reg.iters[0]) == 2 and int(reg.n_src[0]) == 3 and int(reg.n_tgt[0]) == 5
    ops, nbytes = k1_work(reg)
    assert ops == 2 * 3 * 5 * 3 and nbytes == 8 * (3 + 5)


def test_work_counts_only_valid_points():
    reg = ref.Registration(torch.zeros(2, 3), torch.zeros(2), torch.tensor([4, 0]), torch.tensor([10, 7]),
                           torch.tensor([100, 50]))
    ops, nbytes = k1_work(reg)
    assert ops == 2 * 10 * 100 * 5 + 2 * 7 * 50 * 1 and nbytes == 8 * 110 + 8 * 57
