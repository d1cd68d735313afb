"""Cost analysis of the LM steps: the aten-op cost counter
(:mod:`repro_torch.analysis.opcount`) and the three-term roofline with
H100 constants (:mod:`repro_torch.analysis.roofline`)."""
