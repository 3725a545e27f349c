"""Plain PyTorch references of the benchmark's configurations, in f32 with
TF32 off. They import no module of the program under test and take nothing
it made: each makes its weights and data again from the seed
(``harness/inputs.py``)."""
