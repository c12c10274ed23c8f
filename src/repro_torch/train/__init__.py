"""Training: AdamW with bfloat16 / block-scaled int8 state (`optim`), the
train step (`step`), the loop with resume and async checkpoints
(`loop`) and int8 error-feedback gradient compression (`compress`)."""
