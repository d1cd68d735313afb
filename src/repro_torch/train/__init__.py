"""LM training: AdamW (``optimizer``), step-atomic checkpoints
(``checkpoint``), the train loop (``trainer``) and the preemption /
recovery loop (``fault_tolerance``)."""
