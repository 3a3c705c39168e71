"""A2S scripts shared by the port's tests and ``chip_smoke.py``."""

# Polyphonic wavetable voices panmixed into the master bus (saw
# notes, sine bells, noise hats): every voice is wtosc -> panmix, so a
# superblock records oscillator runs (linear and ramp-replayed, noise
# included) and panmix/copy stage rows only.  256 loop iterations of
# 35 ms plus a 1.5 s tail: about 10.5 s of audio.
SLICE_SONG = """
Note(P V=1 Pn=0)
{
	struct { wtosc; panmix }
	w saw; p P; pan Pn
	a V; d 30
	a (V * .4); d 300
	p (P + .5); a 0; d 600
}
Bell(P V=1)
{
	struct { wtosc; panmix }
	w sine; p P
	a V; d 10
	a 0; d 1500
}
Hat(V=1)
{
	struct { wtosc; panmix }
	w noise; p 5
	a V; d 5
	a 0; d 60
}
Song()
{
	!n 0
	256 {
		Note (n * .0833 - 1) .02 (n * .004 - .5)
		Bell (n * .0833) .01
		Hat .05
		+n 1
		d 35
	}
	d 1500
}
"""

# Effects: saw leads through filter12 and dcblock, fm2 bells, both into
# a stereo feedback delay, the whole song through a stereo limiter on
# the master bus.  140 loop steps of 70 ms plus a 1.5 s tail: about
# 11 s of audio.  A 2752x64-frame superblock records one dense stereo
# fbdelay item (fb/ld/rd 300/200/250 ms), the master limiter (one
# instance), and filter12, dcblock and fm items of about 60 instances.
# The argument T (default 0) transposes the leads and bells.
EFFECTS_SONG = """
Lead(P V=1)
{
	struct { wtosc; filter12; dcblock db; panmix }
	lp .5; bp .4; hp .2
	w saw; p P; a (V * .3)
	cutoff 3; q 1.5
	db.cutoff 2n
	d 30
	cutoff (P + 2); q .7; d 200
	a 0; d 150
}
Bell(P V=1)
{
	struct { fm2; panmix }
	p P; a V; p1 (P + 1); a1 .5; fb .2
	d 10
	a 0; d 350
}
Echo(T=0)
{
	struct { inline 0 2; fbdelay 2 2; panmix 2 > }
	fbdelay 300; ldelay 200; rdelay 250
	drygain .7; fbgain .3; lgain .3; rgain .3
	!n 0
	140 {
		Lead (T + n * .0833 - 1) .3
		Bell (T + n * .0833 + 1) .1
		+n 1
		d 70
	}
	d 1500
}
Song(T=0)
{
	struct { inline 0 2; panmix PM 2 2; limiter L 2 > }
	L.release 64; L.threshold 4
	1:Echo T
	d 11000
}
"""

# A mono fbdelay voice that starts 100 ms into the song: the first
# superblock covers the delay only partly, so the instance takes the
# fbdelay's legacy form (a 2^20 ring) for the whole song.  About 1.4 s.
LATE_FBDELAY_SONG = """
Song(V=1)
{
	struct { wtosc; fbdelay; panmix }
	drygain .5; fbgain .4; lgain .4; rgain .4
	w saw; a (V * .3); p 0n
	d 1100
	a 0
	d 100
}

export SongMain(V=1)
{
	struct { inline; panmix }
	d 100
	1:Song V
	d 1300
}
"""

# The float stage tier's test song (the JAX package's tests/test_quality.py
# _FLOAT_SRC): two saw leads through a damped filter12 and a dcblock, with
# ten random cutoff / q steps each, into a stereo limiter.  About 2.4 s.
FLOAT_SONG = """
FilterLead(P V=1)
{
        struct { wtosc; filter12; dcblock db; panmix }
        lp .5; bp .4; hp .2
        w saw; p P; a (V * .3); set a
        cutoff 3; q 1.5; set cutoff; set q
        db.cutoff 2n
        d 200
        10 {
                cutoff (rand 4 + 1); q (rand 2 + .3)
                set cutoff; set q
                d 180
        }
        a 0; d 400
}

export Song(P V=1)
{
        struct { inline 0 2; panmix PM 2 2; limiter L 2 > }
        L.release 64; L.threshold 4
        PM.vol .8
        1:FilterLead (P + 2); d 300
        1:FilterLead P; d 1800
        end
}
"""

# FLOAT_SONG with damped filters: script q is the filter12 resonance
# (internal damping Q = 1/(256 q) in the units where 1.0 = 1 << 24), and
# FLOAT_SONG's q of 0.3-2.3 is damping 0.002-0.013, below the float
# tier's eligibility threshold (0.15), so its filter12 class keeps the
# exact scan.  Here q 0.003-0.013 is damping 0.3-1.3: every class takes
# the float tier.
DAMPED_SONG = FLOAT_SONG.replace("q 1.5;", "q .008;").replace(
    "q (rand 2 + .3)", "q (rand .01 + .003)")

# A resonant filter12 voice (the JAX package's tests/test_quality.py
# _RESO_SRC): script q .1 is internal damping Q ~ 0.039, far below the
# float tier's eligibility threshold (0.15), so under stage_mode="float"
# the class keeps the exact scan.  1.2 s, mono.
RESO_SONG = """
export Song(P V=1)
{
        struct { wtosc; filter12; panmix }
        lp 1; bp 1; hp .5
        q .1; set q; cutoff (P + 3); set cutoff
        w saw; a .8; set a; p P
        d 900; a 0; d 300
}
"""

# the songs by name, with the program each starts
SONGS = {"slice": (SLICE_SONG, "Song"), "effects": (EFFECTS_SONG, "Song"),
         "late_fbdelay": (LATE_FBDELAY_SONG, "SongMain"),
         "float": (FLOAT_SONG, "Song"), "damped": (DAMPED_SONG, "Song"),
         "reso": (RESO_SONG, "Song")}
