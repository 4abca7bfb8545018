"""Device trade -> tax bridge (journal emission -> yearly activity).

Port of ``letf_tpu/tax/device_bridge.py``: ``replay_trades`` (with the
``_PRICE_FLOOR`` share-count guard), ``_packed_pos``, ``_prefix_cost``
(``_prefix_cost_pre`` / ``_fill``), the wash-sale matching (kernel K8,
``ops/wash.py``), ``_wash_unload``, the FIFO buckets on the merged share
coordinate (``_fifo_year_buckets_merge``: ``_fifo_merge_pre`` / ``_post``),
the banded and dense FIFO oracles (``_fifo_year_buckets``,
``_fifo_year_buckets_dense`` with ``_pair_buckets``), the six elected lot
orders (``_election_key``, ``_election_year_buckets``), ``max_buy_events``,
``_asset_yearly_activity`` and ``yearly_activity_from_emission`` with their
``method`` / ``lot_capacity`` dispatch. FIFO runs the merged form; its
column sorts go through ``ops/sort_bridge.sort_bridge`` (kernel K7 for the
merge and valley kinds). The oracles serve the tests, as in the reference.

Layout: per-day tensors are ``[S, B]`` and the merged share coordinate is
``[2S, B]`` (days first, trials contiguous); the yearly activity returns as
``[B, Y, 5]`` (st_gains, st_losses, lt_gains, lt_losses,
wash_disallowed), as the reference's does. The elections' fixed-capacity
lot arrays are ``[B, L]``, as the reference's. The suffix fills of the
reference's associative scans are a nearest-index search (reverse cummin)
plus a gather, and the banded oracle gathers its lot bands where the
reference rolled them: each picks the same elements, so the result is the
same. The unit-staged drive (``yearly_activity_staged`` / ``_units``) that
worked around a TPU compile helper is not ported.
"""

from __future__ import annotations

import torch

from letf_tpu_torch import config as cfg
from letf_tpu_torch.ops.sort_bridge import sort_bridge
from letf_tpu_torch.ops.wash import wash_matching

_DAYS_PER_YEAR = 252
_LT_DAYS = 365
_MIN_SHARES = 0.001
_WINDOW = 30
# Share-count overflow guard of the reference (deep-ruin prices underflow
# toward float32 denormals): the whole share economy runs at a price
# floored at 1e-8 dollars.
_PRICE_FLOOR = 1e-8
_SEC_TAG = 1 << 24

IDX_TQQQ = cfg.ASSET_INDEX["TQQQ"]
IDX_SPY = cfg.ASSET_INDEX["SPY"]
_BRIDGE_ASSETS = (IDX_TQQQ, IDX_SPY)   # assets taxable strategies trade


def replay_trades(tj_alloc, tj_value, tj_price, tj_asset):
    """One strategy column's emission ([S, B] each) -> per-day trades
    through the share-exact journal rule: target = alloc * value / price,
    trade iff |target - held| >= 0.001 shares, held -> target. Returns
    buy_sh and sell_sh [A2, S, B] (A2 = the bridge assets) and the floored
    price [S, B]. Everything downstream computes in the emission's float
    dtype, the share coordinates included; the report's callers hand it
    float64 columns, since a float32 coordinate near 10^7 shares is one
    share apart."""
    S, B = tj_alloc.shape
    price = torch.clamp_min(tj_price, _PRICE_FLOOR)
    valid = ~torch.isnan(tj_alloc)
    target = torch.where(valid, tj_alloc * tj_value / price, 0.0)
    aids = torch.tensor(_BRIDGE_ASSETS, device=tj_asset.device)
    mine = valid[:, None] & (tj_asset.to(torch.int64)[:, None]
                             == aids[None, :, None])            # [S, A2, B]
    held = torch.zeros((len(_BRIDGE_ASSETS), B), dtype=tj_alloc.dtype,
                       device=tj_alloc.device)
    change = torch.empty_like(mine, dtype=tj_alloc.dtype)
    do = torch.empty_like(mine)
    for t in range(S):
        change[t] = torch.where(mine[t], target[t] - held, 0.0)
        do[t] = mine[t] & (torch.abs(change[t]) >= _MIN_SHARES)
        held = torch.where(do[t], target[t], held)
    buy = torch.where(do & (change > 0), change, 0.0)
    sell = torch.where(do & (change < 0), -change, 0.0)
    return {"buy_sh": buy.transpose(0, 1).contiguous(),
            "sell_sh": sell.transpose(0, 1).contiguous(), "price": price}


def _packed_pos(n: int, B: int, device):
    """[n, B] int32 secondary sort key (tag << 24) | position, tag 1 for
    the second half: unique per column, and the (key, packed) order is the
    stable (key, tag) order."""
    pos = torch.arange(n, dtype=torch.int32, device=device)
    packed = torch.where(pos >= n // 2, pos | _SEC_TAG, pos)
    return packed[:, None].expand(n, B).contiguous()


def _pad_days(x, value=0):
    """x [S, B] padded with ``value`` by the wash window on both ends."""
    pad = torch.full((_WINDOW, x.shape[1]), value, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x, pad])


def _nearest_at_or_after(mask):
    """For each row of a [N, B] mask, the index of the nearest row at or
    after it where the mask holds (clamped to N - 1), and whether one
    exists."""
    N = mask.shape[0]
    idx = torch.where(mask, torch.arange(N, device=mask.device)[:, None], N)
    nxt = torch.flip(torch.cummin(torch.flip(idx, [0]), dim=0).values, [0])
    return nxt.clamp_max(N - 1), nxt < N


def _fill(values, nxt, has, default):
    return [torch.where(has, torch.gather(v, 0, nxt), d)
            for v, d in zip(values, default)]


def _prefix_cost_pre(take, cb_prev, q, p):
    """The [2S, B] valley-sort operands (queries first, lots second) and
    the last-lot clamp columns (pc_prev, cb_prev, q, p at day S-1)."""
    pc_prev = torch.cumsum(q * p, dim=0) - q * p        # cost of lots [0, i)
    m = torch.cummax(cb_prev + q, dim=0).values
    z = torch.zeros_like(take)
    val = torch.cat([take, m])
    pcv, cbpv, qv, pv = (torch.cat([z, a]) for a in (pc_prev, cb_prev, q, p))
    lasts = [pc_prev[-1], cb_prev[-1], q[-1], p[-1]]
    return val, pcv, cbpv, qv, pv, lasts


def _prefix_cost_fill(val, is_lot, pcv, cbpv, qv, pv, lasts):
    """Sorted order in and out: each query takes the nearest lot at or
    after it (lot S-1 past the last boundary) and evaluates the pristine
    FIFO prefix cost there."""
    nxt, has = _nearest_at_or_after(is_lot)
    pc_f, cbp_f, q_f, p_f = _fill((pcv, cbpv, qv, pv), nxt, has, lasts)
    part = torch.clamp(val - cbp_f, min=torch.zeros_like(q_f), max=q_f)
    return pc_f + part * p_f


def _prefix_cost(take, cb_prev, q, p):
    """Cost of the first ``take`` shares of the pristine FIFO lot list,
    per sell day: a valley sort of queries into the lots' cumulative-share
    boundaries (K7), a suffix fill, and a restore sort."""
    S, B = q.shape
    val, pcv, cbpv, qv, pv, lasts = _prefix_cost_pre(take, cb_prev, q, p)
    packed = _packed_pos(2 * S, B, q.device)
    val, packed, pcv, cbpv, qv, pv = sort_bridge(
        val, packed, (pcv, cbpv, qv, pv), kind="valley",
        head_payloads_zero=True)
    cost = _prefix_cost_fill(val, packed >= _SEC_TAG, pcv, cbpv, qv, pv,
                             lasts)
    _, cost = sort_bridge(packed, None, (cost,), kind="sort")
    return cost[:S]


def _wash_unload(dis, rep_off, has, buy_q, sell_m, price):
    """Disallowed losses onto their replacement lots, section 1223(4)
    tacked origin days, per-share adjusted basis, the wash-window any-buy
    flags and the cumulative-sold frontier (cs, basis_ps, orig, anybuy)."""
    S, B = buy_q.shape
    days = torch.arange(S, device=buy_q.device)
    basis_adj = torch.zeros_like(buy_q)
    tacked = torch.zeros((S, B), dtype=torch.bool, device=buy_q.device)
    dis_pad, off_pad, has_pad = (_pad_days(dis), _pad_days(rep_off, 99),
                                 _pad_days(has, False))
    for o in range(-_WINDOW, _WINDOW + 1):
        if o == 0:
            continue
        src = slice(_WINDOW - o, _WINDOW - o + S)   # the sell at day b - o
        hit = has_pad[src] & (off_pad[src] == o)
        basis_adj = basis_adj + torch.where(hit, dis_pad[src], 0.0)
        tacked = tacked | hit
    # The pristine prefix always consumes from lot 0, so the earliest
    # consumed original day is the trial's first buy day.
    has_buy = buy_q > _MIN_SHARES
    first_buy = torch.where(has_buy, days[:, None], S).amin(dim=0)
    orig = torch.where(tacked, first_buy[None, :], days[:, None])
    cs = torch.cumsum(sell_m, dim=0)
    basis_ps = price + basis_adj / torch.clamp_min(buy_q, 1e-30)
    qp = _pad_days(buy_q)
    anybuy = torch.zeros((S, B), dtype=torch.bool, device=buy_q.device)
    for o in range(-_WINDOW, _WINDOW + 1):
        if o != 0:
            anybuy = anybuy | (qp[_WINDOW + o:_WINDOW + o + S] > _MIN_SHARES)
    return cs, basis_ps, orig, anybuy


def _fifo_merge_pre(cs, cb, price, basis_ps, orig, anybuy):
    """The [2S, B] merge-sort operands: keys are the running maxima of
    the cumulative bought (lots) and sold (sells) shares; lots carry
    (basis, 2 * origin day), sells (price, 2 * day + any-buy flag)."""
    S, B = price.shape
    dt = price.dtype
    days = torch.arange(S, dtype=dt, device=price.device)
    cs = torch.cummax(cs, dim=0).values
    cb = torch.cummax(cb, dim=0).values
    key = torch.cat([cb, cs])
    va = torch.cat([basis_ps, price])
    vb = torch.cat([orig.to(dt) * 2.0,
                    days[:, None].expand(S, B) * 2.0 + anybuy.to(dt)])
    return key, va, vb


def _fifo_merge_post(key, is_sell, va, vb, n_years: int):
    """Each merged segment's owning sell and lot (nearest at or after),
    the per-segment term/sign/wash buckets, and their sums per tax year
    -> [B, Y, 5]."""
    N, B = key.shape
    S = N // 2
    dt = key.dtype
    zero = torch.zeros(B, dtype=dt, device=key.device)
    nxt_s, has_s = _nearest_at_or_after(is_sell)
    nxt_l, has_l = _nearest_at_or_after(~is_sell)
    p_own, d2_own = _fill((va, vb), nxt_s, has_s, (zero, zero))
    b_own, o2_own = _fill((va, vb), nxt_l, has_l, (zero, zero))
    d_own = torch.floor(d2_own * 0.5)
    ab_own = d2_own - 2.0 * d_own
    o_own = o2_own * 0.5

    amt = torch.clamp_min(key - torch.cat([zero[None], key[:-1]]), 0.0)
    valid = has_s & has_l
    amt = torch.where(valid, amt, 0.0)
    gl = amt * (p_own - b_own)
    lt = (d_own - o_own) > _LT_DAYS
    wash = (gl < 0) & (ab_own > 0.5)
    buckets = [torch.where(~wash & ~lt & (gl > 0), gl, 0.0),
               torch.where(~wash & ~lt & (gl < 0), -gl, 0.0),
               torch.where(~wash & lt & (gl > 0), gl, 0.0),
               torch.where(~wash & lt & (gl < 0), -gl, 0.0),
               torch.where(wash, -gl, 0.0)]

    # The owning sell day is non-decreasing along the merged axis and the
    # unowned segments form a suffix: year y ends where d_own reaches
    # 252 (y + 1).
    d_sorted = torch.where(valid, d_own, 2.0 * S)
    pos = torch.stack([(d_sorted < _DAYS_PER_YEAR * (y + 1.0)).sum(0)
                       for y in range(n_years)])                 # [Y, B]
    outs = []
    for v in buckets:
        c = torch.cat([zero[None], torch.cumsum(v, dim=0)])
        z_y = torch.gather(c, 0, pos)
        outs.append(z_y - torch.cat([zero[None], z_y[:-1]]))
    return torch.stack(outs, dim=-1).transpose(0, 1)              # [B, Y, 5]


def _fifo_year_buckets_merge(cs, price, cb, basis_ps, orig, anybuy,
                             n_years: int):
    """Per-year FIFO buckets on the merged share coordinate: one K7 merge
    of the two cumulative curves, then ``_fifo_merge_post``."""
    S, B = price.shape
    key, va, vb = _fifo_merge_pre(cs, cb, price, basis_ps, orig, anybuy)
    packed = _packed_pos(2 * S, B, price.device)
    key, packed, va, vb = sort_bridge(key, packed, (va, vb), kind="merge")
    return _fifo_merge_post(key, packed >= _SEC_TAG, va, vb, n_years)


def _asset_yearly_activity(buy_q, sell_m, price, n_years: int,
                           method: str = "FIFO",
                           lot_capacity: int | None = None):
    """Passes 1 + 2 for one asset: [S, B] buy shares, sell shares and
    prices -> [B, Y, 5]. ``method``: the lot election; FIFO runs the
    merged form, the six elected orders the day scan over fixed-capacity
    lot arrays (``_election_year_buckets``), which needs ``lot_capacity``
    >= the most buy events of a trial."""
    cb = torch.cumsum(buy_q, dim=0)
    cb_prev = cb - buy_q
    take = torch.minimum(sell_m, cb[-1:])
    cost1 = _prefix_cost(take, cb_prev, buy_q, price)
    gl1 = sell_m * price - cost1
    loss1 = torch.where((sell_m > 0) & (gl1 < 0), -gl1, 0.0)
    dis, rep_off, has = wash_matching(loss1, sell_m, buy_q)
    cs, basis_ps, orig, anybuy = _wash_unload(dis, rep_off, has, buy_q,
                                              sell_m, price)
    if method == "FIFO":
        return _fifo_year_buckets_merge(cs, price, cb, basis_ps, orig,
                                        anybuy, n_years)
    if method not in ELECTION_METHODS:
        raise ValueError(f"method must be one of {ELECTION_METHODS}, got "
                         f"{method!r}")
    if lot_capacity is None:
        raise ValueError(f"method={method} requires lot_capacity")
    return _election_year_buckets(buy_q, sell_m, price, basis_ps, orig,
                                  anybuy, n_years, method, lot_capacity)


def _pair_buckets(cs_t, csp_t, p_t, day_t, abuy_t, cbp_b, q_b, bp_b, or_b,
                  lot_mask):
    """Bucketed gains of one (sell tile x lot band) pair block: sell-side
    [Jt, B] and lot-side [L, B] arrays, lot_mask [L, B] -> per sell
    [Jt, B, 5] (st_g, st_l, lt_g, lt_l, wash)."""
    cb_b = cbp_b + q_b
    amt = (torch.minimum(cs_t[:, None], cb_b[None])
           - torch.maximum(csp_t[:, None], cbp_b[None]))
    amt = torch.clamp_min(amt, 0.0) * lot_mask[None]               # [J, L, B]
    gl = amt * (p_t[:, None] - bp_b[None])
    lt = (day_t[:, None] - or_b[None]) > _LT_DAYS
    wash = (gl < 0) & abuy_t[:, None]
    return torch.stack([
        torch.where(~wash & ~lt & (gl > 0), gl, 0.0).sum(1),
        torch.where(~wash & ~lt & (gl < 0), -gl, 0.0).sum(1),
        torch.where(~wash & lt & (gl > 0), gl, 0.0).sum(1),
        torch.where(~wash & lt & (gl < 0), -gl, 0.0).sum(1),
        torch.where(wash, -gl, 0.0).sum(1)], dim=-1)


def _year_sum(per_day, day0: int, n_years: int):
    """[J, B, 5] per-day buckets of days day0 .. day0 + J - 1 -> [B, Y, 5]
    summed by tax year (days past the last year dropped)."""
    days = torch.arange(day0, day0 + per_day.shape[0],
                        device=per_day.device)
    onehot = ((days // _DAYS_PER_YEAR)[:, None]
              == torch.arange(n_years, device=per_day.device)[None, :])
    return torch.einsum("jbk,jy->byk", per_day, onehot.to(per_day.dtype))


def _fifo_year_buckets_dense(cs, cs_prev, price, cb, cb_prev, buy_q,
                             basis_ps, orig, anybuy, n_years: int):
    """The O(S^2) triangular pairing of every sell with every earlier lot
    (the test oracle of the banded and merged forms)."""
    S, B = price.shape
    days = torch.arange(S, device=price.device)
    out = torch.zeros((B, n_years, 5), dtype=price.dtype,
                      device=price.device)
    for j0 in range(0, S, _DAYS_PER_YEAR):
        j1 = min(j0 + _DAYS_PER_YEAR, S)
        per_sell = _pair_buckets(
            cs[j0:j1], cs_prev[j0:j1], price[j0:j1],
            days[j0:j1, None].expand(j1 - j0, B), anybuy[j0:j1],
            cb_prev[:j1], buy_q[:j1], basis_ps[:j1], orig[:j1],
            torch.ones((j1, B), dtype=price.dtype, device=price.device))
        out = out + _year_sum(per_sell, j0, n_years)
    return out


def _fifo_year_buckets(cs, cs_prev, price, cb, cb_prev, buy_q, basis_ps,
                       orig, anybuy, n_years: int, band: int = 768):
    """The banded FIFO frontier (the merged form's test oracle): each
    year tile of sells pairs with the band of L lots from the first lot
    not fully consumed before the tile, and further L-lot levels run while
    some trial's frontier passes the band's end, so a sell that consumes
    more than L outstanding lots stays exact."""
    S, B = price.shape
    dt = price.dtype
    dev = price.device
    L = min(band, S)
    max_levels = -(-S // L)
    lots = torch.stack([cb_prev, buy_q, basis_ps, orig.to(dt)])  # [4, S, B]
    out = torch.zeros((B, n_years, 5), dtype=dt, device=dev)
    for j0 in range(0, S, _DAYS_PER_YEAR):
        j1 = min(j0 + _DAYS_PER_YEAR, S)
        cs_t, csp_t, p_t = cs[j0:j1], cs_prev[j0:j1], price[j0:j1]
        abuy_t = anybuy[j0:j1]
        day_t = torch.arange(j0, j1, device=dev)[:, None].expand(j1 - j0, B)
        # Lots fully consumed before the tile's first sell: cb <= csp.
        p0 = (cb <= csp_t[:1]).sum(0)                                  # [B]

        def level_block(lvl):
            idx = p0[None, :] + lvl * L + torch.arange(L, device=dev)[:, None]
            band_l = torch.gather(lots, 1, idx.clamp_max(S - 1)[None]
                                  .expand(4, L, B))
            lot_mask = (idx < j1).to(dt)      # FIFO: no lots past the tile
            return _pair_buckets(cs_t, csp_t, p_t, day_t, abuy_t,
                                 band_l[0], band_l[1], band_l[2], band_l[3],
                                 lot_mask)

        def more_needed(lvl):
            # A sell reaches past the band iff its frontier exceeds the
            # band-end lot's cumulative bought shares (and lots remain).
            end = p0 + (lvl + 1) * L - 1
            has_more = end + 1 < j1
            at = end.clamp_max(S - 1)[None]
            cb_end = (torch.gather(cb_prev, 0, at)
                      + torch.gather(buy_q, 0, at))[0]
            return bool((has_more & (cs_t[-1] > cb_end)).any())

        per_sell = level_block(0)
        lvl = 1
        need = more_needed(0)
        while need and lvl < max_levels:
            per_sell = per_sell + level_block(lvl)
            need = more_needed(lvl)
            lvl += 1
        out = out + _year_sum(per_sell, j0, n_years)
    return out


ELECTION_METHODS = ("FIFO", "LIFO", "HIFO", "LOFO", "LTFO", "STFO",
                    "MINTAX")
_MINTAX_ST_RATE = 0.37     # the reference's lot_selection defaults
_MINTAX_LT_RATE = 0.20


def _election_key(method: str, slot_t, slot_basis, slot_orig, t: int,
                  price_t, S: int):
    """Per-lot ascending sort key [B, L] of the elected consumption order;
    ties resolve to the buy order through a stable sort."""
    f = price_t.dtype
    tf = slot_t.to(f)
    if method == "LIFO":
        return -tf
    if method == "HIFO":
        return -slot_basis
    if method == "LOFO":
        return slot_basis
    is_lt = (t - slot_orig) > _LT_DAYS
    zero = torch.zeros((), dtype=f, device=price_t.device)
    big = torch.full((), 4 * S, dtype=f, device=price_t.device)
    if method == "LTFO":
        # LT lots first, each group by holding desc == original day asc.
        return torch.where(is_lt, zero, big) + slot_orig.to(f)
    if method == "STFO":
        # ST lots first, each group by holding asc == original day desc.
        return torch.where(is_lt, big, zero) + (S - slot_orig.to(f))
    if method == "MINTAX":
        gain_ps = price_t[:, None] - slot_basis
        st = torch.full((), _MINTAX_ST_RATE, dtype=f, device=price_t.device)
        lt = torch.full((), _MINTAX_LT_RATE, dtype=f, device=price_t.device)
        rate = torch.where(gain_ps >= 0, torch.where(is_lt, lt, st), st)
        return gain_ps * rate
    return tf                                                       # FIFO


def _election_year_buckets(buy_q, sell_m, price, basis_ps, orig, anybuy,
                           n_years: int, method: str, L: int):
    """Elected-order lot consumption: a day loop over fixed-capacity lot
    arrays [B, L] (slot k = the trial's k-th buy event, the host tracker's
    positions-list order). Each day the lots bought before it and above
    dust are sorted by the election key (stable), consumed greedily along
    that order by a cumulative clip, and their gains bucketed by term,
    sign and wash flag; the days are summed by tax year."""
    S, B = price.shape
    dt = price.dtype
    dev = price.device
    has = (buy_q > _MIN_SHARES).T                                  # [B, S]
    ordv = torch.cumsum(has.to(torch.int64), dim=1) - 1
    slot = torch.where(has & (ordv < L), ordv, L)   # others land past L

    def scat(val, fill):
        base = torch.full((B, L + 1), fill, dtype=val.dtype, device=dev)
        return base.scatter_(1, slot, val)[:, :L]

    day_grid = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(
        B, S)
    slot_t = scat(day_grid, S)                       # buy day (S = unused)
    rem = scat(buy_q.T, 0.0)
    slot_basis = scat(basis_ps.T, 0.0)
    slot_orig = scat(orig.T.to(torch.int32), S)
    per_day = torch.empty((S, B, 5), dtype=dt, device=dev)
    inf = torch.full((), float("inf"), dtype=dt, device=dev)
    for t in range(S):
        sell_t, price_t, any_t = sell_m[t], price[t], anybuy[t]
        live = (slot_t < t) & (rem > _MIN_SHARES)  # today's buy not sellable
        key = _election_key(method, slot_t, slot_basis, slot_orig, t,
                            price_t, S)
        key = torch.where(live, key.to(dt), inf)
        order = torch.sort(key, dim=1, stable=True).indices
        rem_s = torch.gather(rem * live, 1, order)
        cum = torch.cumsum(rem_s, dim=1)
        cons_s = torch.clamp(sell_t[:, None] - (cum - rem_s),
                             min=torch.zeros_like(rem_s), max=rem_s)
        consumed = torch.empty_like(cons_s).scatter_(1, order, cons_s)
        gl = consumed * (price_t[:, None] - slot_basis)
        lt = (t - slot_orig) > _LT_DAYS
        wash = (gl < 0) & any_t[:, None]
        act = consumed > 0
        per_day[t] = torch.stack([
            torch.where(act & ~wash & ~lt & (gl > 0), gl, 0.0).sum(-1),
            torch.where(act & ~wash & ~lt & (gl < 0), -gl, 0.0).sum(-1),
            torch.where(act & ~wash & lt & (gl > 0), gl, 0.0).sum(-1),
            torch.where(act & ~wash & lt & (gl < 0), -gl, 0.0).sum(-1),
            torch.where(act & wash, -gl, 0.0).sum(-1)], dim=-1)
        rem = rem - consumed
    return _year_sum(per_day, 0, n_years)


def max_buy_events(tj_alloc, tj_value, tj_price, tj_asset) -> int:
    """The most buy events of one (trial, asset) in an emission: the
    smallest safe ``lot_capacity`` of the elected orders (a host sync)."""
    tr = replay_trades(tj_alloc, tj_value, tj_price, tj_asset)
    return int((tr["buy_sh"] > _MIN_SHARES).sum(dim=1).max())


def yearly_activity_from_emission(tj_alloc, tj_value, tj_price, tj_asset,
                                  n_years: int, assets: tuple,
                                  method: str = "FIFO",
                                  lot_capacity: int | None = None):
    """One strategy column's emission ([S, B] each) -> ([B, Y, 5] yearly
    activity, trade counts [B], viol). ``assets``: the indices into the
    bridge assets (0 = TQQQ, 1 = SPY) this batch can trade; the others are
    skipped, and ``viol``, a 0-dim bool, is True iff a skipped asset sold
    shares (the caller must refuse the result then). ``method`` /
    ``lot_capacity``: the lot election (``_asset_yearly_activity``)."""
    tr = replay_trades(tj_alloc, tj_value, tj_price, tj_asset)
    out = torch.zeros((tj_alloc.shape[1], n_years, 5), dtype=tj_alloc.dtype,
                      device=tj_alloc.device)
    viol = torch.zeros((), dtype=torch.bool, device=tj_alloc.device)
    for k in range(len(_BRIDGE_ASSETS)):
        if k not in assets:
            viol = viol | (tr["sell_sh"][k] > _MIN_SHARES).any()
            continue
        out = out + _asset_yearly_activity(
            tr["buy_sh"][k], tr["sell_sh"][k], tr["price"], n_years,
            method=method, lot_capacity=lot_capacity)
    n_trades = ((tr["buy_sh"] > 0) | (tr["sell_sh"] > 0)).sum(
        dim=(0, 1), dtype=torch.int32)
    return out, n_trades, viol
