"""Disaggregated serving; so far only the pipeline-parallel engine programs
(``pp_engine``)."""
