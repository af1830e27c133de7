"""Traffic generators, one per kind of traffic; a cell's file under
``chipbench/workloads/`` holds the parameters one of them reads."""
