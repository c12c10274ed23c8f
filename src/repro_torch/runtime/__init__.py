"""Runtime decision logic: heartbeats, stragglers, elastic plans and the
supervised retry (`fault`)."""
