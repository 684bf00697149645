"""The defense kernels: fused Krum scores, the trimmed mean, the median
and their masked variants.

:func:`krum_scores` — fused distance -> Krum score (csrc/krum_scores.cu):
each row's score sums its k smallest distances to the other rows, through
the complement identity rowsum - (sum of the c = f - 1 (+2 paper) largest):
the distance kernel's Gram and epilogue into an (n, n) scratch matrix,
then one block per row selects its c largest.  It returns the rowsums
too, for the caller's cancellation guard (defenses/kernels.py).  A bf16
matrix takes the bf16 operand route of the Gram, as the JAX kernel does.

The coordinate-wise kernels take f32; their wrappers widen a bf16 matrix
to f32 first, as the JAX package's wrappers do.

:func:`trimmed_mean_of` — median-anchored trimmed mean per coordinate
(csrc/trimmed_mean.cu): subtract the median, keep the k values of
smallest magnitude in stable order, return their mean plus the median.

:func:`median_of` — jnp.median along the clients (csrc/median.cu).

:func:`masked_trimmed_mean` — the trimmed mean over the rows a quarantine
mask keeps alive, k = max(e - k_delta, 1) with e the alive count, the
mean optionally weighted per row (csrc/masked_trimmed_mean.cu).

:func:`masked_median` — the median over the alive rows, or the lower
weighted median (csrc/masked_median.cu).

All four take one of two routes, chosen by :func:`trim_plan`: up to 128
rows, a sort of each column in one thread's registers
(csrc/trim_sort.cuh); past that, the radix selection of
csrc/coord_select.cuh.  The masked kernels derive e and k from the mask
on the device, so a call reads nothing back to the host.  Each wrapper
runs its CUDA kernel on a CUDA tensor and its plain PyTorch version
(``*_plain``, beside it) on a CPU tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from attacking_federate_learning_tpu_torch.ops import _build
from attacking_federate_learning_tpu_torch.ops.distances import (
    device_gram_plan, gram_operations, gram_route, gram_workspace,
    pairwise_distances_plain
)
from attacking_federate_learning_tpu_torch.utils.costs import (
    KernelCost, counted_kernel
)


def krum_complement(n: int, corrupted_count: int,
                    paper_scoring: bool = False) -> int:
    """c: how many of a row's n - 1 distances the score drops — f - 1, or
    f + 1 under paper scoring (k = n - f (- 2) kept)."""
    comp = corrupted_count - 1 + (2 if paper_scoring else 0)
    if not 0 <= comp <= max(n - 1, 0):
        raise ValueError(
            f"fused Krum scores need 0 <= f-1(+2) <= n-1 entries per row "
            f"(n={n}, f={corrupted_count}, paper_scoring={paper_scoring})")
    return comp


def krum_scores_plain(G: torch.Tensor, corrupted_count: int,
                      paper_scoring: bool = False):
    """(n, d) -> ((n,) scores, (n,) rowsums) in plain PyTorch: the JAX
    package's ``_krum_scores(method='topk')`` arithmetic without its
    guard (rowsum minus the c largest off-diagonal distances)."""
    comp = krum_complement(G.shape[0], corrupted_count, paper_scoring)
    return krum_rows_plain(pairwise_distances_plain(G), comp)


def krum_rows_plain(D: torch.Tensor, comp: int):
    """(n, n) distances -> ((n,) scores, (n,) rowsums): each row's sum of
    its off-diagonal entries minus its ``comp`` largest (``topk``)."""
    n = D.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=D.device)
    rowsum = torch.where(off, D, 0.0).sum(1)
    if comp == 0:
        return rowsum.clone(), rowsum
    top = torch.topk(torch.where(off, D, -torch.inf), comp, dim=1).values
    return rowsum - torch.clamp(top, min=0.0).sum(1), rowsum


def krum_rows_cost(n: int) -> KernelCost:
    """The per-row selection's work: four radix passes and two sums over
    each of the n^2 entries, D read once, scores and rowsums written."""
    return KernelCost(6 * n * n, 4 * n * n + 8 * n)


@counted_kernel("krum_rows", lambda D, *a, **k: krum_rows_cost(D.shape[0]))
def krum_rows(D: torch.Tensor, comp: int):
    """(n, n) f32 distances -> ((n,) scores, (n,) rowsums): kernel 2's
    per-row selection on a matrix computed elsewhere (the model axis'
    split Gram, ops/distances.py:gram_epilogue)."""
    n = D.shape[0]
    if not 0 <= comp <= max(n - 1, 0):
        raise ValueError(f"krum_rows needs 0 <= comp <= n - 1, got {comp} "
                         f"at n = {n}")
    if D.device.type == "cpu":
        return krum_rows_plain(D, comp)
    _build.check_cuda_matrix(D, "krum_rows")
    fn = _build.entry_point("krum_rows")
    scores = torch.empty(n, dtype=torch.float32, device=D.device)
    rowsums = torch.empty(n, dtype=torch.float32, device=D.device)
    status = fn(D.data_ptr(), n, comp, scores.data_ptr(), rowsums.data_ptr(),
                _build.stream_handle(D))
    _build.check_status("krum_rows", status)
    _build.LAUNCHES["krum_rows"] += 1
    return scores, rowsums


def krum_scores_cost(n: int, d: int, bf16: bool = False) -> KernelCost:
    """Kernel 2's work at (n, d): kernel 1's operations, G read once and
    the (n,) scores and rowsums written once."""
    return KernelCost(gram_operations(n, d), (2 if bf16 else 4) * n * d
                      + 8 * n, "bf16" if bf16 else "fp32")


def trimmed_mean_cost(n: int, d: int) -> KernelCost:
    """Kernel 3's work: three operations an element (the median's
    subtraction, the key, the kept sum), the (n, d) f32 matrix read and
    the (d,) mean written."""
    return KernelCost(3 * n * d, 4 * (n * d + d))


def median_cost(n: int, d: int) -> KernelCost:
    """Kernel 4's work: one operation an element, the matrix read and
    the (d,) median written."""
    return KernelCost(n * d, 4 * (n * d + d))


def masked_cost(n: int, d: int, alive: int, weighted: bool,
                per_element: int) -> KernelCost:
    """Kernels 5 and 6 (``per_element`` 3 and 1): only the ``alive`` rows
    are read (with their weights), the (n,) mask and the (d,) answer."""
    return KernelCost(per_element * alive * d,
                      4 * (alive * d + d) + n + (4 * alive if weighted
                                                 else 0))


def _alive(mask) -> int:
    return int(mask.sum())


@counted_kernel(lambda G, *a, **k: gram_route("krum_scores", G),
                lambda G, *a, **k: krum_scores_cost(
                    *G.shape, G.dtype == torch.bfloat16))
def krum_scores(G: torch.Tensor, corrupted_count: int,
                paper_scoring: bool = False):
    """(n, d) f32 or bf16 -> ((n,) scores, (n,) rowsums), f32."""
    if G.device.type == "cpu":
        return krum_scores_plain(G, corrupted_count, paper_scoring)
    name = gram_route("krum_scores", G)
    _build.check_cuda_matrix(G, name)
    n, d = G.shape
    comp = krum_complement(n, corrupted_count, paper_scoring)
    fn = _build.entry_point(name)
    plan = device_gram_plan(G)
    ws = gram_workspace(G, plan)
    D = torch.empty((n, n), dtype=torch.float32, device=G.device)
    scores = torch.empty(n, dtype=torch.float32, device=G.device)
    rowsums = torch.empty(n, dtype=torch.float32, device=G.device)
    status = fn(G.data_ptr(), n, d, comp, *plan.launch_args, ws.data_ptr(),
                D.data_ptr(), scores.data_ptr(), rowsums.data_ptr(),
                _build.stream_handle(G))
    _build.check_status(name, status)
    _build.LAUNCHES[name] += 1
    return scores, rowsums


def widened(G: torch.Tensor) -> torch.Tensor:
    """A bf16 matrix as f32 (exact), what the coordinate kernels take;
    any other matrix as it is."""
    return G.float() if G.dtype == torch.bfloat16 else G


TRIM_SORT_ROWS = 128   # the most rows the sort route takes (trim_sort.cuh)
TRIM_SORT_STEP = 4     # its padded row counts: 32, 36, ..., 128
TRIM_SORT_MAX_D = 2 ** 30 - 1   # it keeps the row stride in 32 bits


class TrimPlan(NamedTuple):
    """The route of the trimmed-mean and median kernels: ``"sort"`` keeps
    a column's
    ``padded`` (32, 36, ..., 128; at least n) keys in one thread's
    registers and sorts them; ``"select"`` (``padded`` 0) selects by
    radix, one warp a column, for any n."""

    route: str
    padded: int


def trim_plan(n: int, d: int) -> TrimPlan:
    """The route for an (n, d) matrix: up to 128 rows the sort, padded to
    the next multiple of 4 (at least 32), since its registers and
    comparators grow with the padding; radix selection past that (and for
    d of 2^30 or more)."""
    if n < 1 or d < 1:
        raise ValueError(f"trim_plan needs n, d >= 1, got {n}, {d}")
    if n > TRIM_SORT_ROWS or d > TRIM_SORT_MAX_D:
        return TrimPlan("select", 0)
    return TrimPlan("sort", max(32, -(-n // TRIM_SORT_STEP) * TRIM_SORT_STEP))


def _checked_plan(n: int, d: int, plan: Optional[TrimPlan]) -> TrimPlan:
    """``plan``, or :func:`trim_plan`'s, once it is known to fit (n, d)."""
    if plan is None:
        return trim_plan(n, d)
    sizes = range(32, TRIM_SORT_ROWS + 1, TRIM_SORT_STEP)
    fits = (plan.route == "select" and plan.padded == 0) or (
        plan.route == "sort" and plan.padded in sizes and n <= plan.padded
        and d <= TRIM_SORT_MAX_D)
    if not fits:
        raise ValueError(f"sort-route plan {plan} does not fit "
                         f"(n, d) = ({n}, {d})")
    return plan


def trimmed_mean_of_plain(G: torch.Tensor,
                          number_to_consider: int) -> torch.Tensor:
    """(n, d) -> (d,) in plain PyTorch, the JAX package's
    ``defenses/kernels.py:trimmed_mean_of``: jnp.median's midpoint median
    ((lo + hi) * 0.5 of the middle order statistics — not
    ``torch.median``, which returns the lower one), a stable argsort of
    |G - med| along the client axis, and the mean of the first k
    deviations plus the median."""
    n = G.shape[0]
    srt = torch.sort(G, dim=0).values
    med = (srt[(n - 1) // 2] + srt[n // 2]) * 0.5
    dev = G - med[None, :]
    order = torch.sort(dev.abs(), dim=0, stable=True).indices
    kept = dev.gather(0, order[:number_to_consider])
    return kept.mean(0) + med


@counted_kernel("trimmed_mean",
                lambda G, *a, **k: trimmed_mean_cost(*G.shape))
def trimmed_mean_of(G: torch.Tensor, number_to_consider: int,
                    plan: Optional[TrimPlan] = None) -> torch.Tensor:
    """(n, d) f32, k static -> (d,) f32 median-anchored trimmed mean.  A
    CUDA tensor takes ``plan``'s route (default: :func:`trim_plan`'s)."""
    n = G.shape[0]
    k = int(number_to_consider)
    if not 1 <= k <= n:
        raise ValueError(f"trimmed mean keeps 1 <= k <= n values, got "
                         f"k={k}, n={n}")
    G = widened(G)
    if G.device.type == "cpu":
        return trimmed_mean_of_plain(G, k)
    name = "trimmed_mean"
    _build.check_cuda_matrix(G, name)
    d = G.shape[1]
    plan = _checked_plan(n, d, plan)
    fn = _build.entry_point(name)
    out = torch.empty(d, dtype=torch.float32, device=G.device)
    status = fn(G.data_ptr(), n, d, k, plan.padded, out.data_ptr(),
                _build.stream_handle(G))
    _build.check_status(name, status)
    _build.LAUNCHES[name] += 1
    return out


def median_of_plain(G: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (d,) in plain PyTorch: jnp.median along the clients, the
    midpoint of the two middle order statistics (torch.median returns
    the lower one)."""
    n = G.shape[0]
    srt = torch.sort(G, dim=0).values
    return (srt[(n - 1) // 2] + srt[n // 2]) * 0.5


@counted_kernel("median", lambda G, *a, **k: median_cost(*G.shape))
def median_of(G: torch.Tensor,
              plan: Optional[TrimPlan] = None) -> torch.Tensor:
    """(n, d) f32 -> (d,) f32 coordinate-wise median.  A CUDA tensor takes
    ``plan``'s route (default: :func:`trim_plan`'s); both routes give the
    same bits."""
    G = widened(G)
    if G.device.type == "cpu":
        return median_of_plain(G)
    name = "median"
    _build.check_cuda_matrix(G, name)
    n, d = G.shape
    plan = _checked_plan(n, d, plan)
    fn = _build.entry_point(name)
    out = torch.empty(d, dtype=torch.float32, device=G.device)
    status = fn(G.data_ptr(), n, d, plan.padded, out.data_ptr(),
                _build.stream_handle(G))
    _build.check_status(name, status)
    _build.LAUNCHES[name] += 1
    return out


def masked_median_plain(G: torch.Tensor, mask: torch.Tensor,
                        weights=None) -> torch.Tensor:
    """(n, d), (n,) bool[, (n,) weights] -> (d,) in plain PyTorch, the JAX
    package's ``defenses/kernels.py:masked_median``: dead rows sort last
    as +inf, the median of the e alive values is (srt[(e-1)//2] +
    srt[e//2]) / 2 (e = 0 gives +inf).  With weights: the lower weighted
    median, the first sorted value whose cumulative alive weight reaches
    half the alive weight."""
    vals = torch.where(mask[:, None], G, torch.inf)
    srt, order = torch.sort(vals, dim=0, stable=True)
    if weights is not None:
        w = torch.where(mask, weights, 0.0)
        cum = torch.cumsum(w[order], dim=0)
        pick = (cum >= w.sum() / 2.0).to(torch.int32).argmax(0)
        return srt.gather(0, pick[None, :])[0]
    e = mask.sum()
    # The indices wrap like jnp.take's: e = 0 reads the last and first
    # rows, +inf both.
    lo, hi = srt.index_select(
        0, torch.stack([(e - 1) // 2, e // 2]) % G.shape[0])
    return (lo + hi) / 2


@counted_kernel("masked_median",
                lambda G, mask, weights=None, *a, **k: masked_cost(
                    *G.shape, _alive(mask), weights is not None, 1))
def masked_median(G: torch.Tensor, mask: torch.Tensor, weights=None,
                  plan: Optional[TrimPlan] = None) -> torch.Tensor:
    """(n, d) f32, (n,) bool mask[, (n,) f32 weights] -> (d,) f32: the
    median of the alive rows, or their lower weighted median.  ``plan``
    as for :func:`median_of`."""
    G = widened(G)
    if G.device.type == "cpu":
        return masked_median_plain(G, mask, weights)
    name = "masked_median"
    _build.check_cuda_matrix(G, name)
    _build.check_cuda_rows(G, mask, weights, name)
    n, d = G.shape
    plan = _checked_plan(n, d, plan)
    fn = _build.entry_point(name)
    out = torch.empty(d, dtype=torch.float32, device=G.device)
    status = fn(G.data_ptr(), mask.data_ptr(),
                0 if weights is None else weights.data_ptr(), n, d,
                int(weights is not None), plan.padded, out.data_ptr(),
                _build.stream_handle(G))
    _build.check_status(name, status)
    _build.LAUNCHES[name] += 1
    return out


def masked_trimmed_mean_plain(G: torch.Tensor, mask: torch.Tensor,
                              k_delta: int, weights=None) -> torch.Tensor:
    """(n, d), (n,) bool, k_delta[, (n,) weights] -> (d,) in plain
    PyTorch, the JAX package's ``masked_trimmed_mean_of`` with keep count
    e - k_delta: the alive median anchor, dead rows keyed +inf in a
    stable argsort of |dev|, the first k = max(e - k_delta, 1) kept, and
    their mean (or kept-weight mean, mass >= 1e-12) plus the anchor."""
    n = G.shape[0]
    med = masked_median_plain(G, mask)
    dev = G - med[None, :]
    key = torch.where(mask[:, None], dev.abs(), torch.inf)
    order = torch.sort(key, dim=0, stable=True).indices
    sdev = dev.gather(0, order)
    k = torch.clamp(mask.sum() - k_delta, min=1)
    keep = torch.arange(n, device=G.device)[:, None] < k
    if weights is not None:
        w = torch.where(mask, weights, 0.0)
        wk = torch.where(keep, w[order], 0.0)
        mass = torch.clamp(wk.sum(0), min=1e-12)
        return (wk * sdev).sum(0) / mass + med
    return torch.where(keep, sdev, 0.0).sum(0) / k + med


@counted_kernel("masked_trimmed_mean",
                lambda G, mask, k_delta, weights=None, *a, **k: masked_cost(
                    *G.shape, _alive(mask), weights is not None, 3))
def masked_trimmed_mean(G: torch.Tensor, mask: torch.Tensor, k_delta: int,
                        weights=None,
                        plan: Optional[TrimPlan] = None) -> torch.Tensor:
    """(n, d) f32, (n,) bool mask, k_delta >= 0[, (n,) f32 weights] ->
    (d,) f32 trimmed mean of the alive rows keeping max(e - k_delta, 1)
    values per coordinate: k_delta = f + 1 for TrimmedMean, 2f + 1 for
    Bulyan's tail.  ``plan`` as for :func:`trimmed_mean_of`."""
    k_delta = int(k_delta)
    if k_delta < 0:
        raise ValueError(f"masked trimmed mean needs k_delta >= 0, got "
                         f"{k_delta}")
    G = widened(G)
    if G.device.type == "cpu":
        return masked_trimmed_mean_plain(G, mask, k_delta, weights)
    name = "masked_trimmed_mean"
    _build.check_cuda_matrix(G, name)
    _build.check_cuda_rows(G, mask, weights, name)
    n, d = G.shape
    plan = _checked_plan(n, d, plan)
    fn = _build.entry_point(name)
    out = torch.empty(d, dtype=torch.float32, device=G.device)
    status = fn(G.data_ptr(), mask.data_ptr(),
                0 if weights is None else weights.data_ptr(), n, d, k_delta,
                int(weights is not None), plan.padded, out.data_ptr(),
                _build.stream_handle(G))
    _build.check_status(name, status)
    _build.LAUNCHES[name] += 1
    return out
