"""Host-side helpers: image codecs and image tools (numpy and the standard
library only), and the stage spans and the trace exporter (`profiling`,
over ``torch.profiler``)."""
