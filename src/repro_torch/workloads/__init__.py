"""The paper's workloads (Table 6)."""
