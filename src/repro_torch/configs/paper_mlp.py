"""The paper's own case study (Fig. 7): 3 inputs, 4 hidden layers × 4 nodes,
2 outputs, tanh activations — plus the Fig. 10 generator-scaling specs
(8-in/8-out, 14 and 31 hidden layers × 32 nodes); the port's copy of
``repro/configs/paper_mlp.py``."""

from repro_torch.core.synthesis import NetworkSpec

CASE_STUDY = NetworkSpec(num_inputs=3, num_hidden_layers=4, nodes_per_layer=4,
                         num_outputs=2, activation="tanh")

FIG10_A = NetworkSpec(num_inputs=8, num_hidden_layers=14, nodes_per_layer=32,
                      num_outputs=8, activation="tanh")

FIG10_B = NetworkSpec(num_inputs=8, num_hidden_layers=31, nodes_per_layer=32,
                      num_outputs=8, activation="tanh")
