"""BNN arithmetic, crossbar tile specs and the execution-engine registry."""
