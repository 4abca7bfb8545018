"""One plain engine a configuration's ``engine_mode``, found by that name:
``summaries(rows, seed, horizon_years, config, glue, device)``."""
