"""The prediction-service layer: planner, executor, ``ModelBank`` and the
``LatencyOracle`` facade."""
