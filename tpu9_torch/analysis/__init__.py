"""Static analysis of the port (counterpart of ``tpu9/analysis``): the
graph check (``graphcheck``), which verifies the serving graphs' sharding,
dtype and in-place invariants, and the finding record it reports in
(``findings``)."""
