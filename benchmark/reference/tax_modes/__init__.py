"""The comparison's part for a traffic's ``tax_mode``, found by that name:
``numbers(cell, report, seed) -> {name: gap}``, each judged against the
cell's limits file as the row and reduction numbers are."""
