"""Fleet-batched SLAM: many robots in one step."""
