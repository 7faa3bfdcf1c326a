"""One file per scenario family, found by the family's name: each has
``build(n, **params) -> Model`` (``benchmark.reference.engine.Model``)."""
