"""Paper theory: optimal scalings, contraction factors, stepsizes, rates.

Implements Sect. 2.5 (Props 1-2), Sect. 4 (Thms 1-2, Remarks 1-3) and Sect. 5
(Thm 3) so that EF-BV can run fully auto-tuned: given (eta, omega, omega_av)
of the compressors and (L, Ltilde) of the objective there is *no* free
parameter left (Remark 1).

The function-by-function map to the paper, with runnable examples, lives in
docs/theory.md; :func:`participation_eta` / :func:`participation_omega` /
:func:`tune_partial` extend the auto-tuning to the federated (per-round
client sampling) regime by composing Bernoulli participation into the
compressor's certified constants.

This module is a copy of ``repro/core/theory.py`` (pure math,
no JAX), kept in the port so that the port imports nothing of ``repro``;
tests/test_torch_theory.py pins the two equal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal, Optional

Mode = Literal["efbv", "ef21", "diana"]
Regime = Literal["pl", "kl", "nonconvex"]


# --- Prop. 1: effect of scaling ------------------------------------------------

def scaled_eta(lam: float, eta: float) -> float:
    return lam * eta + 1.0 - lam


def scaled_omega(lam: float, omega: float) -> float:
    return lam * lam * omega


def r_of(lam: float, eta: float, omega: float) -> float:
    """r = (1 - lam + lam*eta)^2 + lam^2 * omega  (Sect. 4)."""
    return scaled_eta(lam, eta) ** 2 + scaled_omega(lam, omega)


# --- Prop. 2: optimal scaling --------------------------------------------------

def lambda_star(eta: float, omega: float) -> float:
    """argmin_lam r(lam) clipped to (0, 1]:  min((1-eta)/((1-eta)^2+omega), 1)."""
    if eta >= 1.0:
        raise ValueError(f"eta must be < 1, got {eta}")
    return min((1.0 - eta) / ((1.0 - eta) ** 2 + omega), 1.0)


def nu_star(eta: float, omega_av: float) -> float:
    """Same formula with omega replaced by omega_av (Sect. 2.5 / Sect. 4)."""
    return lambda_star(eta, omega_av)


# --- partial participation: Bernoulli client sampling as a compressor ----------

def participation_eta(p: float, eta: float) -> float:
    """Relative bias of the effective operator C'(x) = b C(x), b ~ Bern(p).

    ||E C'(x) - x|| = ||p E C(x) - x|| <= (1 - p(1 - eta)) ||x||: skipping a
    round acts like Prop. 1's downscaling with lam = p on the bias side.
    """
    if not 0.0 < p <= 1.0:
        raise ValueError(f"participation probability in (0, 1] required, got {p}")
    if p == 1.0:  # exact no-op (1 - (1 - eta) would round)
        return eta
    return 1.0 - p * (1.0 - eta)


def participation_omega(p: float, eta: float, omega: float) -> float:
    """Relative variance of C'(x) = b C(x), b ~ Bern(p):

        E||C' - E C'||^2 = p Var[C] + p(1-p) ||E C(x)||^2
                        <= (p omega + p(1-p)(1+eta)^2) ||x||^2 .
    """
    if not 0.0 < p <= 1.0:
        raise ValueError(f"participation probability in (0, 1] required, got {p}")
    if p == 1.0:  # exact no-op
        return omega
    return p * omega + p * (1.0 - p) * (1.0 + eta) ** 2


# --- pipelined rounds: one-round staleness as a compressor perturbation ---------

#: Default per-round drift of the compressed innovation, measured as a
#: fraction of the compressor's contraction SLACK (1 - eta): the pipelined
#: analysis assumes ||u_t - u_{t-1}|| <= drift * (1 - eta) * ||u_{t-1}||.
#: EF-BV's control variates contract the innovation u_t = g_t - h_t at a
#: per-round rate proportional to (1 - eta) (Thm 1's Lyapunov argument), so
#: measuring the drift against the slack keeps the composition valid for
#: EVERY compressor -- weak ones (eta near 1) move their innovations
#: proportionally slower.  Any depth * drift < 1/2 composes to eta' < 1.
DEFAULT_PIPELINE_DRIFT = 1.0 / 32.0


def _check_depth(depth: int) -> int:
    if not isinstance(depth, int) or depth < 0:
        raise ValueError(f"pipeline depth must be an int >= 0, got {depth!r}")
    return depth


def _staleness_rho(depth: int, eta: float, drift: float) -> float:
    """rho_d = depth * drift * (1 - eta), the certified relative movement of
    the innovation across ``depth`` rounds of staleness."""
    if drift < 0.0:
        raise ValueError(f"pipeline drift must be >= 0, got {drift}")
    if not 0.0 <= eta < 1.0:
        raise ValueError(f"eta in [0,1) required, got {eta}")
    rho = depth * drift * (1.0 - eta)
    if rho >= 0.5 * (1.0 - eta):  # i.e. depth * drift >= 1/2
        raise ValueError(
            f"pipelined staleness rho = {depth}*{drift}*(1-{eta}) = {rho} "
            f"leaves no contraction (needs depth * drift < 1/2): use a "
            "shallower pipeline or a smaller certified drift")
    return rho


def pipeline_eta(depth: int, eta: float,
                 drift: float = DEFAULT_PIPELINE_DRIFT) -> float:
    """Relative bias of the effective operator C'(u_t) = C(u_{t-depth}): the
    pipelined schedule applies the message compressed ``depth`` rounds ago.

    Under the bounded relative drift ||u_t - u_{t-1}|| <= rho ||u_{t-1}||
    with rho = drift * (1 - eta) (see DEFAULT_PIPELINE_DRIFT), chaining
    depth rounds gives ||u_{t-depth}|| <= ||u_t|| / (1 - rho_d) and
    ||u_t - u_{t-depth}|| <= rho_d ||u_t|| / (1 - rho_d), rho_d = depth*rho,
    hence

        ||E C(u_{t-depth}) - u_t||
            <= eta ||u_{t-depth}|| + ||u_t - u_{t-depth}||
            <= (eta + rho_d) / (1 - rho_d) * ||u_t||  =:  eta' ||u_t|| .

    eta' < 1 automatically whenever depth * drift < 1/2 -- the staleness
    composes for every compressor, exactly like :func:`participation_eta`'s
    interpolation toward 1 ("EF21 with Bells & Whistles"-style composed
    perturbation).  depth = 0 is an exact no-op."""
    if _check_depth(depth) == 0:
        return eta
    rho = _staleness_rho(depth, eta, drift)
    return (eta + rho) / (1.0 - rho)


def pipeline_omega(depth: int, eta: float, omega: float,
                   drift: float = DEFAULT_PIPELINE_DRIFT) -> float:
    """Relative variance of C'(u_t) = C(u_{t-depth}):

        E||C' - E C'||^2 <= omega ||u_{t-depth}||^2
                         <= omega / (1 - rho_d)^2 * ||u_t||^2 ,

    with rho_d = depth * drift * (1 - eta) as in :func:`pipeline_eta`
    (signature mirrors :func:`participation_omega`: the variance inflation
    depends on the bias constant through the slack).  Applies to omega_av
    identically -- the delay is common to all workers, so the 1/n variance
    reduction of independent compressors is untouched.  depth = 0 is an
    exact no-op."""
    if _check_depth(depth) == 0:
        return omega
    rho = _staleness_rho(depth, eta, drift)
    return omega / (1.0 - rho) ** 2


def tune_pipelined(
    eta: float,
    omega: float,
    depth: int,
    *,
    omega_av: Optional[float] = None,
    drift: float = DEFAULT_PIPELINE_DRIFT,
    **kw,
) -> Tuning:
    """Auto-tuning under a ``depth``-round-stale pipelined schedule.

    Composes the staleness into the compressor's certified constants
    (:func:`pipeline_eta` / :func:`pipeline_omega`) and hands the effective
    C(eta', omega') to :func:`tune` -- same machinery, delayed regime.
    depth = 0 reduces to :func:`tune` exactly."""
    eta_d = pipeline_eta(depth, eta, drift)
    omega_d = pipeline_omega(depth, eta, omega, drift)
    if omega_av is not None:
        return tune(eta_d, omega_d,
                    pipeline_omega(depth, eta, omega_av, drift), **kw)
    return tune(eta_d, omega_d, **kw)


# --- rate ingredients -----------------------------------------------------------

def s_star(r: float) -> float:
    """s* = sqrt((1+r)/(2r)) - 1, so that (1+s*)^2 r = (r+1)/2 (proof of Thm 1).

    r -> 0 (no compression error, Remark 2): s* -> inf and 1/s* -> 0, so the
    stepsize bound reverts to plain gradient descent's 1/L."""
    if r <= 0.0:
        return math.inf
    return math.sqrt((1.0 + r) / (2.0 * r)) - 1.0


def s_nonconvex(r: float) -> float:
    """s = 1/sqrt(r) - 1, so that (1+s)^2 r = 1 (Thm 3)."""
    if r <= 0.0:
        return math.inf
    return 1.0 / math.sqrt(r) - 1.0


def theta_of(s: float, r: float, r_av: float) -> float:
    """theta = s (1+s) r / r_av."""
    if r_av <= 0.0:
        return math.inf
    return s * (1.0 + s) * r / r_av


# --- stepsizes -------------------------------------------------------------------

def gamma_max(L: float, Ltilde: float, r: float, r_av: float, regime: Regime = "pl") -> float:
    """Largest stepsize allowed by Thm 1 (pl / nonconvex, eq. 8/13) or Thm 2 (kl, eq. 10)."""
    if r >= 1.0:
        raise ValueError(f"need r < 1 for convergence, got r={r}")
    if r <= 0.0:  # identity compression: plain (prox-)GD stepsizes (Remark 2)
        return 1.0 / (2.0 * L) if regime == "kl" else 1.0 / L
    if regime == "nonconvex":
        s = s_nonconvex(r)
        return 1.0 / (L + Ltilde * math.sqrt(r_av / r) / s)
    s = s_star(r)
    if regime == "kl":
        return 1.0 / (2.0 * L + Ltilde * math.sqrt(r_av / r) / s)
    return 1.0 / (L + Ltilde * math.sqrt(r_av / r) / s)


def linear_rate(gamma: float, mu: float, r: float, regime: Regime = "pl") -> float:
    """Per-iteration contraction factor of the Lyapunov function (Thms 1-2)."""
    if regime == "kl":
        return max(1.0 / (1.0 + 0.5 * gamma * mu), (r + 1.0) / 2.0)
    return max(1.0 - gamma * mu, (r + 1.0) / 2.0)


# --- one-stop tuning --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Tuning:
    """Everything EF-BV needs, derived per Remark 1."""

    mode: Mode
    eta: float
    omega: float
    omega_av: float
    lam: float
    nu: float
    r: float
    r_av: float
    s: float
    theta: float
    gamma: Optional[float]  # None if L/Ltilde not supplied
    rate: Optional[float]  # None if mu not supplied

    @property
    def speedup_vs_ef21(self) -> float:
        """The paper's headline factor sqrt(r_av / r) (Sect. 4.1): gamma scales
        by its inverse relative to EF21's choice nu = lam."""
        return math.sqrt(self.r_av / self.r)


def tune(
    eta: float,
    omega: float,
    omega_av: Optional[float] = None,
    *,
    n: Optional[int] = None,
    mode: Mode = "efbv",
    regime: Regime = "pl",
    L: Optional[float] = None,
    Ltilde: Optional[float] = None,
    mu: Optional[float] = None,
) -> Tuning:
    """Derive (lam, nu, gamma) for EF-BV / EF21 / DIANA.

    - mode='efbv' : lam = lam*, nu = nu*          (Remark 1 -- recommended)
    - mode='ef21' : nu = lam = lam*               (Sect. 3.1; r_av := r)
    - mode='diana': nu = 1, lam = lam*            (Sect. 3.2)
    """
    if omega_av is None:
        if n is None:
            raise ValueError("need omega_av or n (independent compressors)")
        omega_av = omega / n
    if not 0.0 <= eta < 1.0:
        raise ValueError(f"eta in [0,1) required, got {eta}")

    lam = lambda_star(eta, omega)
    if mode == "efbv":
        nu = nu_star(eta, omega_av)
    elif mode == "ef21":
        nu = lam
    elif mode == "diana":
        nu = 1.0
    else:
        raise ValueError(mode)

    r = r_of(lam, eta, omega)
    if mode == "ef21":
        # EF21 analysis does not see omega_av: it treats the aggregate like a
        # single worker, i.e. r_av = r (Sect. 4.1).
        r_av = r
    else:
        r_av = r_of(nu, eta, omega_av)

    s = s_nonconvex(r) if regime == "nonconvex" else s_star(r)
    theta = theta_of(s, r, r_av)

    gamma = None
    if L is not None and Ltilde is not None:
        gamma = gamma_max(L, Ltilde, r, r_av, regime)
    rate = None
    if gamma is not None and mu is not None and regime != "nonconvex":
        rate = linear_rate(gamma, mu, r, regime)

    return Tuning(
        mode=mode, eta=eta, omega=omega, omega_av=omega_av,
        lam=lam, nu=nu, r=r, r_av=r_av, s=s, theta=theta,
        gamma=gamma, rate=rate,
    )


def tune_partial(
    eta: float,
    omega: float,
    p: float,
    *,
    n: int,
    **kw,
) -> Tuning:
    """Auto-tuning under per-round Bernoulli(p) client sampling.

    Composes participation into the compressor's certified per-worker
    constants (participation_eta / participation_omega) and hands the
    effective C(eta', omega') to :func:`tune` -- same machinery, sampled
    regime.  Participation masks are independent across workers, so the
    averaged variance keeps the 1/n reduction: omega_av' = omega'/n
    (fixed-size sampling of s = p*n workers is handled with the same
    plug-in p; its without-replacement masks are negatively correlated,
    so this errs on the conservative side).  p = 1 reduces to :func:`tune`
    with omega_av = omega/n exactly.
    """
    eta_p = participation_eta(p, eta)
    omega_p = participation_omega(p, eta, omega)
    return tune(eta_p, omega_p, n=n, **kw)


def tune_for(compressor, d: int, n: int, *, independent: bool = True,
             participation: Optional[float] = None,
             pipeline: Optional[int] = None,
             pipeline_drift: float = DEFAULT_PIPELINE_DRIFT, **kw) -> Tuning:
    """Convenience: read (eta, omega) off a Compressor instance.

    ``participation`` (expected per-round participation fraction p) routes
    through :func:`tune_partial` for the federated regime.  ``pipeline``
    (staleness depth of the pipelined schedule) composes
    :func:`pipeline_eta` / :func:`pipeline_omega` AFTER participation --
    the delay applies to whatever effective operator the round runs;
    None / 0 is an exact no-op.  A *sequence* of compressors is a
    heterogeneous fleet (worker i runs compressor i) and routes through
    :func:`tune_fleet` with the certified worst-case aggregation.
    """
    depth = _check_depth(0 if pipeline is None else pipeline)
    if isinstance(compressor, (list, tuple)):
        if not independent:
            raise ValueError("mixed-fleet tuning assumes independent "
                             "per-worker compressors")
        etas = [c.eta(d) for c in compressor]
        omegas = [c.omega(d) for c in compressor]
        return tune_fleet(etas, omegas, n=n, participation=participation,
                          pipeline=depth, pipeline_drift=pipeline_drift, **kw)
    eta = compressor.eta(d)
    omega = compressor.omega(d)
    if participation is not None and participation < 1.0:
        if not independent:
            raise ValueError("partial participation tuning assumes "
                             "independent per-worker compressors")
        if depth == 0:
            return tune_partial(eta, omega, participation, n=n, **kw)
        p = participation
        eta_p = participation_eta(p, eta)
        omega_p = participation_omega(p, eta, omega)
        # participation masks are independent per worker, so omega_av' =
        # omega'/n (tune_partial's convention); the common one-round delay
        # then scales bias and both variances alike.
        return tune_pipelined(eta_p, omega_p, depth, omega_av=omega_p / n,
                              drift=pipeline_drift, **kw)
    omega_av = compressor.omega_av(d, n) if independent else omega
    if depth:
        return tune_pipelined(eta, omega, depth, omega_av=omega_av,
                              drift=pipeline_drift, **kw)
    return tune(eta, omega, omega_av, **kw)


# --- heterogeneous fleets: per-worker (eta_i, omega_i) aggregation --------------

FleetAggregate = Literal["worst", "mean"]


def fleet_constants(etas, omegas, *, n: Optional[int] = None,
                    aggregate: FleetAggregate = "worst"):
    """Aggregate per-worker certified constants (eta_i, omega_i) of a mixed
    fleet of INDEPENDENT compressors into one (eta, omega, omega_av) triple
    the homogeneous theory can consume.

    * ``worst`` (certified): eta = max_i eta_i and omega = max_i omega_i
      bound every worker's recursion, so Thms. 1-3 hold verbatim with the
      aggregated constants.
    * ``mean`` (averaged): eta = mean(eta_i), omega = mean(omega_i) -- exact
      for homogeneous fleets and for the *averaged* quantities when all
      workers see innovations of equal norm; a tighter but uncertified
      stepsize in general.

    Either way the averaged variance keeps the independent-compressor 1/n
    reduction exactly:  Var[(1/n) sum_i C_i(u_i)] <= (1/n^2) sum_i omega_i
    ||u_i||^2, i.e. omega_av = mean(omega_i)/n against the mean of ||u_i||^2
    (worst-case: max(omega_i)/n).  n = None returns (eta, omega) only.
    """
    etas, omegas = list(etas), list(omegas)
    if not etas or len(etas) != len(omegas):
        raise ValueError(f"need matching non-empty eta/omega lists, got "
                         f"{len(etas)}/{len(omegas)}")
    if aggregate == "worst":
        eta, omega = max(etas), max(omegas)
    elif aggregate == "mean":
        eta, omega = sum(etas) / len(etas), sum(omegas) / len(omegas)
    else:
        raise ValueError(f"fleet aggregate {aggregate!r} (want worst | mean)")
    if n is None:
        return eta, omega
    return eta, omega, omega / max(n, 1)


def tune_fleet(etas, omegas, *, n: int,
               aggregate: FleetAggregate = "worst",
               participation: Optional[float] = None,
               pipeline: Optional[int] = None,
               pipeline_drift: float = DEFAULT_PIPELINE_DRIFT,
               **kw) -> Tuning:
    """Auto-tuning for a heterogeneous worker fleet (worker i's compressor
    certified as C(eta_i, omega_i); all independent).

    Composes per-round Bernoulli(p) participation into EACH member first
    (participation_eta / participation_omega -- skipping a round is a
    per-worker event), then aggregates (:func:`fleet_constants`), composes
    the pipelined staleness last (the delay is common to the whole fleet)
    and hands the result to :func:`tune`.  A homogeneous list reproduces
    :func:`tune_for` / :func:`tune_partial` exactly; pipeline=None/0 is an
    exact no-op.
    """
    if participation is not None and participation < 1.0:
        p = participation
        etas, omegas = zip(*[(participation_eta(p, e),
                              participation_omega(p, e, o))
                             for e, o in zip(etas, omegas)])
    eta, omega, omega_av = fleet_constants(etas, omegas, n=n,
                                           aggregate=aggregate)
    depth = _check_depth(0 if pipeline is None else pipeline)
    if depth:
        return tune_pipelined(eta, omega, depth, omega_av=omega_av,
                              drift=pipeline_drift, **kw)
    return tune(eta, omega, omega_av, **kw)


# --- pytree leaves: per-leaf (eta_j, omega_j) composition ----------------------

def tree_constants(etas, omegas, sizes=None, *, n: Optional[int] = None,
                   aggregate: FleetAggregate = "worst"):
    """Aggregate per-LEAF certified constants (eta_j, omega_j) of a
    pytree-native wire (leaf j compressed by its own independent C_j) into
    one (eta, omega[, omega_av]) triple the homogeneous theory can consume.

    The leaf-wise operator C(x) = (C_1(x_1), ..., C_J(x_J)) acts on DISJOINT
    coordinate blocks of ONE worker's innovation, so the error and variance
    split exactly over leaves:  ||C(x) - x||^2 = sum_j ||C_j(x_j) - x_j||^2
    and Var[C(x)] = sum_j Var[C_j(x_j)].

    * ``worst`` (certified): eta = max_j eta_j, omega = max_j omega_j bound
      the sums above for EVERY split of ||x||^2 over leaves, so Thms. 1-3
      hold verbatim with the aggregated constants.
    * ``mean`` (averaged): exact under the isotropy heuristic ||x_j||^2 =
      w_j ||x||^2 with size weights w_j = size_j / sum(sizes):
      eta = sqrt(sum_j w_j eta_j^2), omega = sum_j w_j omega_j -- tighter
      but uncertified in general (``sizes=None`` weighs leaves equally).

    Unlike a fleet, leaf composition adds NO worker-averaging of its own:
    the 1/n reduction still comes from averaging across the n independent
    workers, omega_av = omega / max(n, 1).  A single leaf is an exact no-op
    under either aggregate.  n = None returns (eta, omega) only.
    """
    etas, omegas = list(etas), list(omegas)
    if not etas or len(etas) != len(omegas):
        raise ValueError(f"need matching non-empty eta/omega lists, got "
                         f"{len(etas)}/{len(omegas)}")
    if sizes is None:
        w = [1.0 / len(etas)] * len(etas)
    else:
        sizes = [float(s) for s in sizes]
        if len(sizes) != len(etas):
            raise ValueError(f"{len(sizes)} leaf sizes for {len(etas)} "
                             "eta/omega pairs")
        total = sum(sizes)
        if total <= 0:
            raise ValueError("leaf sizes must have a positive sum")
        w = [s / total for s in sizes]
    if aggregate == "worst":
        eta, omega = max(etas), max(omegas)
    elif aggregate == "mean":
        eta = math.sqrt(sum(wj * e * e for wj, e in zip(w, etas)))
        omega = sum(wj * o for wj, o in zip(w, omegas))
    else:
        raise ValueError(f"tree aggregate {aggregate!r} (want worst | mean)")
    if n is None:
        return eta, omega
    return eta, omega, omega / max(n, 1)


def tune_tree(etas, omegas, sizes=None, *, n: int,
              aggregate: FleetAggregate = "worst",
              participation: Optional[float] = None,
              pipeline: Optional[int] = None,
              pipeline_drift: float = DEFAULT_PIPELINE_DRIFT,
              **kw) -> Tuning:
    """Auto-tuning for a pytree-native wire with per-leaf compressors.

    Composition order: leaves FIRST (:func:`tree_constants` -- the leaf
    operators compose within one worker's single round message), then
    per-round Bernoulli(p) participation (a per-WORKER event: the whole
    leaf-composed message is present or absent at once), then the pipelined
    staleness, then :func:`tune`.  A single leaf with full participation and
    no pipeline reproduces :func:`tune` on that leaf's constants exactly.
    """
    eta, omega = tree_constants(etas, omegas, sizes, aggregate=aggregate)
    if participation is not None and participation < 1.0:
        eta, omega = (participation_eta(participation, eta),
                      participation_omega(participation, eta, omega))
    omega_av = omega / max(n, 1)
    depth = _check_depth(0 if pipeline is None else pipeline)
    if depth:
        return tune_pipelined(eta, omega, depth, omega_av=omega_av,
                              drift=pipeline_drift, **kw)
    return tune(eta, omega, omega_av, **kw)


def iteration_complexity(L: float, Ltilde: float, mu: float, t: Tuning) -> float:
    """Asymptotic O(.) iteration count to eps-accuracy, eq. (12) (without log)."""
    return L / mu + (Ltilde / mu * math.sqrt(t.r_av / t.r) + 1.0) / (1.0 - t.r)
