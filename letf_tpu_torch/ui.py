"""Terminal UI: analysis date-range selection with non-interactive fallback.

The port's copy of ``letf_tpu/ui.py`` (reference ui.py:7-287): the
predefined start-date menu, custom date entry, cache invalidation on a
range change, and horizon feasibility filtering.
``LETF_NON_INTERACTIVE`` or a stdin that is not a terminal selects the
defaults.
"""

from __future__ import annotations

import calendar
import os
import re
import sys
from datetime import datetime
from typing import List, Tuple

from letf_tpu_torch import config as cfg

_EVENTS = [
    (1929, "Great Depression (1929-1932)"),
    (1941, "World War II (1941-1945)"),
    (1973, "Oil Crisis (1973-1974)"),
    (1987, "Black Monday (1987)"),
    (2000, "Dot-com Crash (2000-2002)"),
    (2008, "Financial Crisis (2008-2009)"),
    (2020, "COVID Crash (2020)"),
]


def _non_interactive() -> bool:
    return (not sys.stdin.isatty() or bool(os.getenv("LETF_NON_INTERACTIVE"))
            or bool(os.getenv("LETF_NONINTERACTIVE")))


def _is_date(text: str) -> bool:
    """True where ``datetime.strptime(text, "%Y-%m-%d")`` accepts the text
    (a four-digit year, one- or two-digit month and day, a real date)."""
    m = re.fullmatch(r"(\d{4})-(\d{1,2})-(\d{1,2})", text)
    if m is None:
        return False
    y, mo, d = (int(g) for g in m.groups())
    return 1 <= mo <= 12 and 1 <= d <= calendar.monthrange(y, mo)[1]


def get_start_date_interactive() -> Tuple[str, str]:
    """Pick the analysis date range; mutates cfg.ANALYSIS_* and clears caches
    when the range changes (reference ui.py:73,126,175)."""
    if _non_interactive():
        print("  [Non-interactive] Using full history "
              f"({cfg.DATA_START_DATE} to {cfg.DATA_END_DATE})")
        return cfg.ANALYSIS_START_DATE, cfg.ANALYSIS_END_DATE

    print("\nSelect analysis start date:")
    for num, opt in cfg.START_DATE_OPTIONS.items():
        events = [name for yr, name in _EVENTS
                  if yr >= int(opt["date"][:4])]
        print(f"  {num}. {opt['date']}  {opt['name']:<16} - {opt['description']}")
        if events:
            print(f"      covers: {', '.join(events[:3])}"
                  + (" ..." if len(events) > 3 else ""))
    print("  7. Custom date")

    choice = input("\nEnter (1-7) [1]: ").strip() or "1"
    if choice == "7":
        raw = input("Start date (YYYY-MM-DD): ").strip()
        if _is_date(raw):
            start = raw
        else:
            print("  Invalid date; using full history")
            start = cfg.DATA_START_DATE
    else:
        opt = cfg.START_DATE_OPTIONS.get(int(choice) if choice.isdigit() else 1,
                                         cfg.START_DATE_OPTIONS[1])
        start = opt["date"]

    if start != cfg.ANALYSIS_START_DATE:
        cfg.ANALYSIS_START_DATE = start
        cfg.clear_all_caches()
    return cfg.ANALYSIS_START_DATE, cfg.ANALYSIS_END_DATE


def validate_time_horizons_for_start_date(start_date: str,
                                          requested: List[int]) -> List[int]:
    """Keep only horizons that fit between the start date and today
    (reference ui.py:264-287)."""
    head = start_date[:4] if isinstance(start_date, str) else ""
    if re.fullmatch(r"\s*[+-]?\d+(_\d+)*\s*", head) is None:
        return requested        # where int() would refuse the year
    start_year = int(head)
    years_available = datetime.now().year - start_year
    feasible = [h for h in requested if h <= max(years_available, 0)]
    dropped = [h for h in requested if h not in feasible]
    if dropped:
        print(f"  Dropped horizons (insufficient data): {dropped}")
    return feasible
