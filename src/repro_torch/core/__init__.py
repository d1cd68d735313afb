"""Dataset, feature clustering, regressors and the PROFET predictor."""
