"""Gas-phase chemical kinetics: CHEMKIN mechanism parsing + forward/reverse
reaction-rate evaluation — the Fuego ``CKPX``/``CKKFKR`` analog behind the
reference's plotQPD (/root/reference/Src/ModelSpecificAnalysis/plotQPD.cpp:
149-156), re-designed for array hardware: the per-cell concentration
products and Gibbs sums are log-space stoichiometric MATMULS
([Ncells, nspec] @ [nspec, nrxn]), so the whole Qf/Qr field evaluation is a
handful of matrix contractions plus elementwise transcendentals instead of
the reference's per-cell scalar loop.  On the jax path every contraction
asks for ``Precision.HIGHEST`` (a float32 matmul may otherwise run in TF32
on the GPU's tensor cores, three digits of a rate exponent).

Supported mechanism features (CHEMKIN-II format):
  * ELEMENTS / SPECIES / THERMO (embedded NASA7) / REACTIONS blocks
  * Arrhenius ``A beta Ea`` (REACTIONS units keywords CAL/MOLE, KCAL/MOLE,
    JOULES/MOLE, KJOULES/MOLE, KELVINS honored for Ea)
  * reversible (<=>, =) with kr from equilibrium, irreversible (=>)
  * explicit reverse Arrhenius (REV /A beta Ea/)
  * third-body reactions (+M) with per-species efficiencies
  * pressure-dependent falloff (+M)/(+species): LOW + Lindemann, TROE
    (3- and 4-parameter), SRI
  * DUPLICATE reactions (kept as independent rows; Fuego does the same)

Units are CGS + mol (concentrations mol/cm^3, rates mol/(cm^3 s)), matching
PelePhysics/Fuego.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .mechanism import Nasa7, R_UNIV, molecular_weight

R_CAL = 1.98720425864083     # cal/(mol K) — Ea/(R T) exponent
P_ATM = 1.01325e6            # dyn/cm^2
_LN10 = float(np.log(10.0))


def _matmul(a, b):
    """``a @ b``; with a jax operand (``xp=jax.numpy`` or a tracer inside
    jit) at full float32 precision, never TF32."""
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return a @ b
    import jax
    import jax.numpy as jnp
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


@dataclasses.dataclass
class KineticReaction:
    """One reaction with rate data (reactants/products exclude M)."""

    reactants: Dict[str, float]
    products: Dict[str, float]
    A: Optional[float] = None          # mol-cm-s-K units
    beta: float = 0.0
    Ea: float = 0.0                    # converted to cal/mol at parse time
    reversible: bool = True
    rev: Optional[Tuple[float, float, float]] = None   # REV/ A beta Ea /
    third_body: bool = False           # plain +M on both sides
    falloff: bool = False              # (+M) / (+species)
    falloff_partner: Optional[str] = None   # (+species): sole collider
    low: Optional[Tuple[float, float, float]] = None
    troe: Optional[Tuple[float, ...]] = None            # 3 or 4 params
    sri: Optional[Tuple[float, ...]] = None             # 3 or 5 params
    efficiencies: Dict[str, float] = dataclasses.field(default_factory=dict)
    duplicate: bool = False
    label: str = ""

    @property
    def has_arrhenius(self) -> bool:
        return self.A is not None


_UNIT_TO_CAL = {
    "CAL/MOLE": 1.0,
    "KCAL/MOLE": 1000.0,
    "JOULES/MOLE": 1.0 / 4.184,
    "KJOULES/MOLE": 1000.0 / 4.184,
    "KELVINS": R_CAL,
    "EVOLTS": 23060.547830619026,
}

_ARROW_RE = re.compile(r"<=>|=>|=")
_EFF_RE = re.compile(r"([A-Za-z][\w()\-*']*)\s*/\s*([0-9.eEdD+\-]+)\s*/")
_AUX_RE = re.compile(r"^(LOW|TROE|SRI|REV|HIGH|PLOG|FORD|RORD)\b", re.I)


def _floats(txt: str) -> List[float]:
    return [float(t.replace("d", "e").replace("D", "E"))
            for t in re.findall(r"[-+]?[\d.]+(?:[eEdD][-+]?\d+)?", txt)]


def _split_reaction_line(line: str) -> Tuple[str, Optional[List[float]]]:
    """Split 'EQN  A beta Ea' — the trailing 3 numbers are the Arrhenius
    coefficients when present; bare equation lines (the legacy qpd.py input)
    have none."""
    toks = line.split()
    if len(toks) >= 4:
        try:
            coeffs = [float(t.replace("D", "E").replace("d", "e"))
                      for t in toks[-3:]]
            eqn = " ".join(toks[:-3])
            if _ARROW_RE.search(eqn):
                return eqn, coeffs
        except ValueError:
            pass
    return line.strip(), None


def _parse_side(txt: str) -> Tuple[Dict[str, float], bool, Optional[str],
                                   bool]:
    """Parse one side of an equation → (stoich, has_plain_M,
    falloff_partner, has_falloff).  ``(+M)``/``(+SP)`` marks falloff; bare
    ``+M`` marks a plain third body."""
    falloff_partner = None
    m = re.search(r"\(\+\s*([\w()\-*']+)\s*\)", txt)
    has_falloff = False
    if m:
        has_falloff = True
        p = m.group(1)
        if p.upper() != "M":
            falloff_partner = p
        txt = txt[:m.start()] + txt[m.end():]
    out: Dict[str, float] = {}
    plain_m = False
    for term in txt.split("+"):
        term = term.strip()
        if not term:
            continue
        if term.upper() == "M":
            plain_m = True
            continue
        mm = re.match(r"^(\d+\.?\d*)\s*(.+)$", term)
        if mm:
            coeff, name = float(mm.group(1)), mm.group(2).strip()
        else:
            coeff, name = 1.0, term
        out[name] = out.get(name, 0.0) + coeff
    return out, plain_m, falloff_partner, has_falloff


def parse_kinetic_reaction(line: str, ea_to_cal: float = 1.0
                           ) -> KineticReaction:
    eqn, coeffs = _split_reaction_line(line)
    m = _ARROW_RE.search(eqn)
    if m is None:
        raise ValueError(f"no arrow in reaction {line!r}")
    arrow = m.group(0)
    lhs, rhs = eqn[:m.start()], eqn[m.end():]
    reversible = arrow in ("<=>", "=")
    rstoich, rM, rpartner, rfo = _parse_side(lhs)
    pstoich, pM, ppartner, pfo = _parse_side(rhs)
    rxn = KineticReaction(
        reactants=rstoich, products=pstoich,
        reversible=reversible,
        third_body=(rM or pM),
        falloff=(rfo or pfo),
        falloff_partner=rpartner or ppartner,
        label=eqn.strip())
    if coeffs is not None:
        rxn.A, rxn.beta, rxn.Ea = coeffs[0], coeffs[1], coeffs[2] * ea_to_cal
    return rxn


def _has_end(toks: List[str]) -> bool:
    return any(t.upper() == "END" for t in toks)


def _species_toks(toks: List[str]) -> List[str]:
    """Species names up to a trailing END terminator — CHEMKIN allows
    'SPECIES H2 O2 N2 END' on one line (r5 review fix: END was being
    collected as a species name)."""
    out = []
    for t in toks:
        if t.upper() == "END":
            break
        out.append(t)
    return out


def parse_chemkin(path: str) -> Tuple[List[str], List[KineticReaction],
                                      Dict[str, Nasa7]]:
    """Parse a CHEMKIN mechanism file → (species, reactions, thermo).

    Tolerant by design: SPECIES/THERMO blocks are optional (species are
    then collected from the reactions), and bare reaction-equation lines
    without Arrhenius coefficients are accepted (legacy plotQPD edge-only
    input)."""
    species: List[str] = []
    reactions: List[KineticReaction] = []
    thermo: Dict[str, Nasa7] = {}
    ea_to_cal = 1.0
    section = ""
    thermo_lines: List[str] = []
    with open(path) as f:
        raw = f.readlines()
    i = 0
    while i < len(raw):
        line = raw[i].split("!")[0].rstrip("\n")
        i += 1
        s = line.strip()
        if not s:
            continue
        up = s.upper()
        head = up.split()[0]
        if head in ("ELEMENTS", "ELEM"):
            section = "elements"
            continue
        if head in ("SPECIES", "SPEC"):
            section = "species"
            species.extend(_species_toks(s.split()[1:]))
            if _has_end(s.split()[1:]):
                section = ""
            continue
        if head in ("THERMO", "THER"):
            section = "thermo"
            # optional 'THERMO ALL' + temperature-range line follow
            continue
        if head in ("REACTIONS", "REAC"):
            section = "reactions"
            for tok in up.split()[1:]:
                if tok in _UNIT_TO_CAL:
                    ea_to_cal = _UNIT_TO_CAL[tok]
            continue
        if head == "END":
            section = ""
            continue
        if section == "species":
            species.extend(_species_toks(s.split()))
            if _has_end(s.split()):
                section = ""
        elif section == "thermo":
            thermo_lines.append(raw[i - 1].rstrip("\n"))
        elif section == "reactions" or (section == "" and
                                        _ARROW_RE.search(s)):
            if _AUX_RE.match(s) or up.startswith("DUP") \
                    or (("/" in s) and not _ARROW_RE.search(s)):
                _apply_aux_line(s, reactions, ea_to_cal)
            else:
                try:
                    reactions.append(parse_kinetic_reaction(s, ea_to_cal))
                except ValueError:
                    continue
    if thermo_lines:
        thermo = _parse_thermo_lines(thermo_lines)
    if not species:
        seen: List[str] = []
        for r in reactions:
            for sp in list(r.reactants) + list(r.products):
                if sp not in seen:
                    seen.append(sp)
        species = seen
    return species, reactions, thermo


def _apply_aux_line(s: str, reactions: List[KineticReaction],
                    ea_to_cal: float) -> None:
    if not reactions:
        return
    rxn = reactions[-1]
    up = s.upper()
    if up.startswith("DUP"):
        rxn.duplicate = True
        return
    m = _AUX_RE.match(s)
    if m:
        key = m.group(1).upper()
        vals = _floats(s[m.end():])
        if key == "LOW" and len(vals) >= 3:
            rxn.low = (vals[0], vals[1], vals[2] * ea_to_cal)
        elif key == "TROE":
            rxn.troe = tuple(vals)
        elif key == "SRI":
            rxn.sri = tuple(vals)
        elif key == "REV" and len(vals) >= 3:
            rxn.rev = (vals[0], vals[1], vals[2] * ea_to_cal)
        elif key in ("HIGH", "PLOG", "FORD", "RORD"):
            raise ValueError(
                f"unsupported CHEMKIN aux keyword {key} on {rxn.label!r}")
        return
    # bare efficiency line: SP/val/ SP/val/ ...  (Fortran D exponents legal)
    for name, val in _EFF_RE.findall(s):
        rxn.efficiencies[name] = float(
            val.replace("d", "e").replace("D", "E"))


def _parse_thermo_lines(lines: List[str]) -> Dict[str, Nasa7]:
    out: Dict[str, Nasa7] = {}
    i = 0
    while i < len(lines):
        ln = lines[i]
        if len(ln) >= 80 and ln[79:80] == "1":
            try:
                name = ln[:18].split()[0]
                t_low = float(ln[45:55])
                t_high = float(ln[55:65])
                t_mid_s = ln[65:73].strip()
                t_mid = float(t_mid_s) if t_mid_s else 1000.0

                def nums(s, n):
                    return [float(s[15 * k: 15 * (k + 1)]) for k in range(n)]

                c = nums(lines[i + 1], 5) + nums(lines[i + 2], 5) \
                    + nums(lines[i + 3], 4)
                out[name] = Nasa7(t_low, t_mid, t_high,
                                  np.array(c[7:14]), np.array(c[:7]))
                i += 4
                continue
            except (ValueError, IndexError):
                pass
        i += 1
    return out


class Kinetics:
    """Vectorized Qf/Qr evaluator over static per-mechanism arrays.

    All per-reaction constants are baked into dense [nr] / [nr, ns] numpy
    arrays at construction; ``qf_qr`` then evaluates any batch of states in
    a few matmuls + elementwise math, with numpy or jax.numpy (pass
    ``xp=jax.numpy`` or call inside jit — the arrays constant-fold)."""

    def __init__(self, species: Sequence[str],
                 reactions: Sequence[KineticReaction],
                 thermo: Optional[Dict[str, Nasa7]] = None):
        self.species = list(species)
        self.reactions = list(reactions)
        self.thermo = thermo or {}
        ns, nr = len(self.species), len(self.reactions)
        sidx = {s: k for k, s in enumerate(self.species)}
        missing = [sp for r in reactions
                   for sp in list(r.reactants) + list(r.products)
                   if sp not in sidx]
        if missing:
            raise ValueError(f"reaction species not in species list: "
                             f"{sorted(set(missing))}")
        if not all(r.has_arrhenius for r in reactions):
            bad = [r.label for r in reactions if not r.has_arrhenius][:3]
            raise ValueError(f"reactions without Arrhenius data: {bad}")

        self.nuf = np.zeros((nr, ns))
        self.nur = np.zeros((nr, ns))
        self.lnA = np.zeros(nr)
        self.kf_sign = np.ones(nr)        # CHEMKIN allows negative A
        self.rev_sign = np.ones(nr)       # (DUPLICATE fit pairs)
        self.beta = np.zeros(nr)
        self.EaR = np.zeros(nr)           # Ea/R in Kelvin
        self.rev_mask = np.zeros(nr)
        self.rev_arrh = np.zeros(nr, dtype=bool)
        self.rev_lnA = np.zeros(nr)
        self.rev_beta = np.zeros(nr)
        self.rev_EaR = np.zeros(nr)
        self.alpha = np.ones((nr, ns))    # third-body efficiencies
        self.tb_mask = np.zeros(nr)       # plain +M multiplier
        self.fo_mask = np.zeros(nr)       # falloff blend
        self.low_lnA = np.zeros(nr)
        self.low_beta = np.zeros(nr)
        self.low_EaR = np.zeros(nr)
        self.troe_mask = np.zeros(nr)
        self.troe = np.zeros((nr, 4))     # a, T***, T*, T** (T**=inf → 0 term)
        self.troe_has_t2 = np.zeros(nr)
        self.sri_mask = np.zeros(nr)
        self.sri = np.zeros((nr, 5))
        self.sri[:, 3] = 1.0              # d default
        for i, r in enumerate(reactions):
            for sp, c in r.reactants.items():
                self.nuf[i, sidx[sp]] += c
            for sp, c in r.products.items():
                self.nur[i, sidx[sp]] += c
            # negative pre-exponentials are legal CHEMKIN (negative-A
            # DUPLICATE fit pairs): carry the sign outside the log
            self.lnA[i] = (np.log(abs(r.A)) if r.A != 0.0 else -np.inf)
            self.kf_sign[i] = -1.0 if r.A < 0 else 1.0
            self.beta[i] = r.beta
            self.EaR[i] = r.Ea / R_CAL
            self.rev_mask[i] = 1.0 if r.reversible else 0.0
            if r.rev is not None:
                self.rev_arrh[i] = True
                self.rev_lnA[i] = (np.log(abs(r.rev[0]))
                                   if r.rev[0] != 0.0 else -np.inf)
                self.rev_sign[i] = -1.0 if r.rev[0] < 0 else 1.0
                self.rev_beta[i] = r.rev[1]
                self.rev_EaR[i] = r.rev[2] / R_CAL
            if r.falloff_partner:
                row = np.zeros(ns)
                row[sidx[r.falloff_partner]] = 1.0
                self.alpha[i] = row
            else:
                for sp, e in r.efficiencies.items():
                    if sp in sidx:
                        self.alpha[i, sidx[sp]] = e
            if r.falloff:
                self.fo_mask[i] = 1.0
                if r.low is None:
                    raise ValueError(f"falloff reaction without LOW: "
                                     f"{r.label!r}")
                if r.low[0] <= 0.0 or r.A < 0:
                    raise ValueError(
                        f"non-positive A on falloff reaction {r.label!r}: "
                        "the k0/kinf blend needs positive rate constants")
                self.low_lnA[i] = np.log(r.low[0])
                self.low_beta[i] = r.low[1]
                self.low_EaR[i] = r.low[2] / R_CAL
                if r.troe is not None:
                    self.troe_mask[i] = 1.0
                    self.troe[i, :len(r.troe)] = r.troe
                    self.troe_has_t2[i] = 1.0 if len(r.troe) >= 4 else 0.0
                elif r.sri is not None:
                    self.sri_mask[i] = 1.0
                    self.sri[i, :len(r.sri)] = r.sri
                    if len(r.sri) < 5:
                        self.sri[i, 3] = 1.0   # d=1
                        self.sri[i, 4] = 0.0   # e=0
            elif r.third_body:
                self.tb_mask[i] = 1.0
        self.nu_net = self.nur - self.nuf
        self.nu_sum = self.nu_net.sum(axis=1)
        def _w(s):
            try:
                return molecular_weight(s)
            except (ValueError, KeyError):
                return np.nan      # only needed for CKPX (pressure_from_rho)
        self.W = np.array([_w(s) for s in self.species])
        # NASA7 coefficient tables for g/RT = h/RT - s/R (reverse rates)
        self._th_lo = np.zeros((ns, 7))
        self._th_hi = np.zeros((ns, 7))
        self._th_tmid = np.full(ns, 1000.0)
        self._have_thermo = np.zeros(ns, dtype=bool)
        for k, s in enumerate(self.species):
            th = self.thermo.get(s)
            if th is not None:
                self._th_lo[k] = th.lo
                self._th_hi[k] = th.hi
                self._th_tmid[k] = th.t_mid
                self._have_thermo[k] = True
        needs_eq = (self.rev_mask > 0) & ~self.rev_arrh
        if needs_eq.any():
            touched = (np.abs(self.nu_net[needs_eq]) > 0).any(axis=0)
            lack = [self.species[k] for k in np.nonzero(touched
                                                        & ~self._have_thermo
                                                        )[0]]
            if lack:
                raise ValueError(
                    "reversible reactions need NASA7 thermo for equilibrium "
                    f"reverse rates; missing species: {lack} (embed a THERMO "
                    "block or pass thermo_file=)")

    @property
    def n_reactions(self) -> int:
        return len(self.reactions)

    # -- state helpers (CKPX analog) -----------------------------------------
    def pressure_from_rho(self, rho_cgs, T, X, xp=np):
        """P [dyn/cm^2] = rho R T / Wbar (CKPX; plotQPD.cpp:151-152)."""
        if np.isnan(self.W).any():
            bad = [s for s, w in zip(self.species, self.W) if np.isnan(w)]
            raise ValueError(f"cannot derive molecular weights for {bad}")
        Wbar = _matmul(X, xp.asarray(self.W))
        return rho_cgs * R_UNIV * T / xp.maximum(Wbar, 1e-300)

    def concentrations(self, P, T, X, xp=np):
        """C_k [mol/cm^3] = X_k P/(R T)."""
        ctot = P / (R_UNIV * T)
        return X * ctot[..., None]

    def _g_RT(self, T, xp):
        """Per-species g0/RT = h/RT − s/R via NASA7 (batched piecewise)."""
        cond = T[..., None, None] < xp.asarray(self._th_tmid[:, None])
        a = xp.where(cond, xp.asarray(self._th_lo),
                     xp.asarray(self._th_hi))       # [..., ns, 7]
        Tb = T[..., None]
        lnT = xp.log(Tb)
        h_RT = (a[..., 0] + a[..., 1] * Tb / 2 + a[..., 2] * Tb**2 / 3
                + a[..., 3] * Tb**3 / 4 + a[..., 4] * Tb**4 / 5
                + a[..., 5] / Tb)
        s_R = (a[..., 0] * lnT + a[..., 1] * Tb + a[..., 2] * Tb**2 / 2
               + a[..., 3] * Tb**3 / 3 + a[..., 4] * Tb**4 / 4 + a[..., 6])
        return h_RT - s_R

    # -- the CKKFKR analog ----------------------------------------------------
    def qf_qr(self, T, C, xp=np):
        """Forward/reverse reaction rates of progress.

        T: [...] K; C: [..., ns] mol/cm^3 → (Qf, Qr) each [..., nr] in
        mol/(cm^3 s).  Pure array math (works with numpy or jax.numpy; all
        mechanism constants fold into the jit graph)."""
        T = xp.asarray(T)
        C = xp.asarray(C)
        cfloor = 1e-300 if C.dtype == np.float64 else 1e-30
        lnT = xp.log(T)
        invT = 1.0 / T
        lnC = xp.log(xp.maximum(C, cfloor))
        # forward rate constants + concentration products (matmuls)
        lnkf = (xp.asarray(self.lnA) + xp.asarray(self.beta) * lnT[..., None]
                - xp.asarray(self.EaR) * invT[..., None])
        ln_pf = _matmul(lnC, xp.asarray(self.nuf.T))
        ln_pr = _matmul(lnC, xp.asarray(self.nur.T))
        # equilibrium: ln Kc = −Σν g/RT + Σν ln(P_atm/(R T))
        g = self._g_RT(T, xp)
        lnKp = -_matmul(g, xp.asarray(self.nu_net.T))
        lnKc = lnKp + xp.asarray(self.nu_sum) * (
            np.log(P_ATM / R_UNIV) - lnT)[..., None]
        lnkr_eq = lnkf - lnKc
        lnkr_ar = (xp.asarray(self.rev_lnA)
                   + xp.asarray(self.rev_beta) * lnT[..., None]
                   - xp.asarray(self.rev_EaR) * invT[..., None])
        lnkr = xp.where(xp.asarray(self.rev_arrh), lnkr_ar, lnkr_eq)
        # signs live outside the log-space math (negative-A duplicates);
        # an equilibrium reverse inherits the forward sign (kr = kf/Kc)
        qr_sign = xp.where(xp.asarray(self.rev_arrh),
                           xp.asarray(self.rev_sign),
                           xp.asarray(self.kf_sign))
        Qf = xp.exp(lnkf + ln_pf) * xp.asarray(self.kf_sign)
        Qr = xp.exp(lnkr + ln_pr) * xp.asarray(self.rev_mask) * qr_sign
        # third-body concentration (one more matmul)
        ctb = _matmul(C, xp.asarray(self.alpha.T))
        # select, not 1 + mask*(ctb - 1): in float32 that sum cancels, and
        # a [M] ~ 1e-5 mol/cm^3 keeps only ~2 digits
        mult = xp.where(xp.asarray(self.tb_mask) > 0, ctb, 1.0)
        # falloff blend: k_eff = k_inf · Pr/(1+Pr) · F
        if self.fo_mask.any():
            lnk0 = (xp.asarray(self.low_lnA)
                    + xp.asarray(self.low_beta) * lnT[..., None]
                    - xp.asarray(self.low_EaR) * invT[..., None])
            prfloor = 1e-300 if C.dtype == np.float64 else 1e-30
            Pr = xp.maximum(xp.exp(lnk0 - lnkf) * ctb, prfloor)
            log10Pr = xp.log(Pr) / _LN10
            F = xp.ones_like(Pr)
            if self.troe_mask.any():
                a = xp.asarray(self.troe[:, 0])
                # Fuego convention (r5 review fix): a zero T***/T* means the
                # corresponding Fcent term is ZERO (exp(-T/T3) -> 0 as
                # T3 -> 0+), not exp(-T/inf) = 1
                m3 = xp.asarray((self.troe[:, 1] != 0.0).astype(float))
                m1 = xp.asarray((self.troe[:, 2] != 0.0).astype(float))
                t3 = xp.asarray(np.where(self.troe[:, 1] == 0.0, 1.0,
                                         self.troe[:, 1]))
                t1 = xp.asarray(np.where(self.troe[:, 2] == 0.0, 1.0,
                                         self.troe[:, 2]))
                t2 = xp.asarray(self.troe[:, 3])
                Tb = T[..., None]
                Fcent = ((1.0 - a) * m3 * xp.exp(-Tb / t3)
                         + a * m1 * xp.exp(-Tb / t1)
                         + xp.asarray(self.troe_has_t2) * xp.exp(-t2
                                                                 * invT[...,
                                                                        None]))
                Fcent = xp.maximum(Fcent, 1e-30)
                log10F_cent = xp.log(Fcent) / _LN10
                c = -0.4 - 0.67 * log10F_cent
                n = 0.75 - 1.27 * log10F_cent
                f1 = (log10Pr + c) / (n - 0.14 * (log10Pr + c))
                log10F_troe = log10F_cent / (1.0 + f1 * f1)
                F = xp.where(xp.asarray(self.troe_mask) > 0,
                             xp.exp(log10F_troe * _LN10), F)
            if self.sri_mask.any():
                a_s = xp.asarray(self.sri[:, 0])
                b_s = xp.asarray(self.sri[:, 1])
                # c == 0: the exp(-T/c) term vanishes (same limit convention
                # as the Troe fix above)
                mc = xp.asarray((self.sri[:, 2] != 0.0).astype(float))
                c_s = xp.asarray(np.where(self.sri[:, 2] == 0.0, 1.0,
                                          self.sri[:, 2]))
                d_s = xp.asarray(self.sri[:, 3])
                e_s = xp.asarray(self.sri[:, 4])
                Tb = T[..., None]
                x = 1.0 / (1.0 + log10Pr * log10Pr)
                base = a_s * xp.exp(-b_s * invT[..., None]) \
                    + mc * xp.exp(-Tb / c_s)
                F_sri = d_s * xp.maximum(base, 1e-300) ** x * Tb ** e_s
                F = xp.where(xp.asarray(self.sri_mask) > 0, F_sri, F)
            blend = Pr / (1.0 + Pr) * F
            mult = xp.where(xp.asarray(self.fo_mask) > 0, blend, mult)
        return Qf * mult, Qr * mult

    def qf_qr_from_state(self, T, rho_cgs, X, xp=np):
        """CKPX + CKKFKR chain from (T, density, mole fractions) — exactly
        the reference's per-cell sequence (plotQPD.cpp:144-156)."""
        P = self.pressure_from_rho(rho_cgs, T, X, xp=xp)
        C = self.concentrations(P, T, X, xp=xp)
        return self.qf_qr(T, C, xp=xp)
