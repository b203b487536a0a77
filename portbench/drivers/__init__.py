"""One driver per kind of measured window; `run(ctx) -> dict` each."""
