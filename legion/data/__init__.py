from legion.data.format import GraphData, load_dataset, save_dataset  # noqa: F401
from legion.data.synthetic import random_power_law_graph  # noqa: F401
