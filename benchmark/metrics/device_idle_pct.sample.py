"""Share of the traced window in which no operation ran on the card:
100 x (1 - union of device activity / window), the mean over the cards."""


def read(ctx, data):
    busy = ctx.get("busy_per_chip") or [ctx["trace"].busy_s]
    window = ctx.get("window_per_chip") or [ctx["window_s"]]
    shares = [1.0 - b / w for b, w in zip(busy, window) if w > 0 and b > 0]
    return 100.0 * sum(shares) / len(shares) if shares else None
