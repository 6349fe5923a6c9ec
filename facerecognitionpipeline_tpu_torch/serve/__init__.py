"""Online serving: trackers, HTTP server/client, live app, device batcher."""
