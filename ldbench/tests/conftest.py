"""Few threads per test process: the tests run several workers at once."""

import torch

torch.set_num_threads(2)
