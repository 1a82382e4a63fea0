"""repro_torch.simlab -- the analytic model of the paper's comparison
(simulator, hardware and cost parameters, TCO), numpy copies of
``repro.simlab``."""
