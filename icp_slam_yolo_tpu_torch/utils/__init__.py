"""Host-side helpers: image codecs and image tools (numpy and the standard
library only), and the profiling scopes (`profiling`, over ``torch.profiler``)."""
