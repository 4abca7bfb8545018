"""``tax_mode="none"``: a pre-tax report carries no post-tax tables, so
this part adds no number; the rows and the reductions are the whole
comparison."""


def numbers(cell, report: dict, seed: int) -> dict:
    return {}
